// dense_gemm: y = x . W^T + b, then optionally exact GELU, for the Dense
// layers of the ViT family (models/vit.py::_Linear, which SAM's encoder in
// models/samvit.py shares): the qkv and output projections and both MLP
// layers of every block.
//
// Replaces no TPU kernel: the JAX package leaves Dense to XLA
// (pbml_mantle_convection_tpu/models/vit.py), and the port called cuBLAS,
// whose float32 GEMM with TF32 off runs on the SIMT units at 32-43 TFLOP/s.
// It was added because those GEMMs took 62% of ViT-Base's forward and 52% of
// SAM ViT-B's at 4,049 tokens.
//
// What bounds it: operations. A ViT-Base forward at 4,049 rows does 687.7
// GFLOP of Dense work (qkv 768 -> 2,304, output 768 -> 768, MLP 768 -> 3,072
// -> 768, 12 blocks): 4.17 ms at the 3xTF32 rate (495/3 TFLOP/s), against
// ~1.3 GB moved (every input, weight and output once): 0.39 ms at 3.35 TB/s.
// Alone at those shapes on an H100 80GB HBM3 (700 W) the 48 launches take
// 5.59 ms, 112-135 TFLOP/s of 3xTF32 work (75% of that bound); their
// products without loads, waits and sums run 5.1 ms.
//
// Design (csrc/projection_conv.cu's, on a plain GEMM). A block of three
// warpgroups computes a tile of 192 rows by 128 output columns, each
// warpgroup 64 rows with wgmma m64n128k8 (TF32), the one route to the tensor
// cores' full TF32 rate, in 3xTF32: a_lo*b_hi + a_hi*b_lo + a_hi*b_hi with
// each operand split as hi = TF32(x), lo = x - hi, float32-accurate, never a
// single TF32 product. The K loop takes 32 inputs a stage, two stages ahead
// of the products, in a four-stage ring that one thread fills with two bulk
// copies (TMA) a stage, reported to the stage's mbarrier: the weights, which
// the wrapper packs once per weight version (ops/dense_gemm.py::pack_weight)
// into one contiguous 32 KB block a stage, already split, hi and lo in
// wgmma's no-swizzle K-major layout (core matrices of 8 rows x 16 bytes);
// and the activations' 192 x 32 floats, read where they lie through a
// tensor map of the (rows, K) float32 rows, 128-byte swizzled, the rows
// past the last zero-filled (the ragged last tile: 4,049 = 21 x 192 + 17).
// Each warp frees a stage's buffers by an arrival on a second mbarrier once
// its products of the stage have completed, so no block-wide barrier runs
// in the K loop: giving the loads and the barrier to one thread and two
// mbarriers took the ViT's 48 launches from 6.77 to 5.59 ms (cp.async by
// every thread and a __syncthreads a stage before). Each lane loads its A
// fragment from the staged rows and splits it in registers; a k-step's
// three products are one commit group, and the next k-step's loads and
// splits overlap them (two register sets, one k-step each). K-step q takes
// the 16-byte units q and q + 4 of a row (k-indices t and t + 4 of lane t
// the floats 2 (t % 2) and + 1 of unit q + 4 (t / 2)), so the fragment
// loads of a half warp (4 rows, 2 units each) fall on 32 banks through the
// swizzle. The
// accumulator holds one stage (12 products of 8 inputs) and is then added to
// float32 register sums that start at the bias: the tensor cores'
// accumulation rounds toward zero, and a chain over all of K (3,072 in MLP2)
// drifts far past a float32 GEMM. The
// epilogue applies GELU as PyTorch computes it (x * 0.5 * (1 + erf(x /
// sqrt 2)) in float32) where asked, and each lane stores its two adjacent
// columns of a row straight into the (rows, N) output, written once.
//
// Tiling: every shape takes tiles of 192 rows by 128 columns, one block per
// SM (its ring fills the shared memory), ceil(M / 192) x N / 128 of them, so
// the grid follows (rows M, output columns N) and nothing else. A launch of T
// tiles runs in ceil(T / SMs) waves and the busiest SM computes
// ceil(T / SMs) x 192 rows. 192-row tiles make the fewest such rows, or tie,
// at every shape of the ViT-Base and SAM ViT-B cells against 128-row tiles
// (two warpgroups), and their 12 warps hide more of a stage's waits, 4-10%
// faster at equal waves (H100). On 132 SMs at M = 4,049 or 4,048: N = 768
// (output, MLP2) makes 22 x 6 = 132 tiles in one wave, where 128 rows would
// make 32 x 6 = 192 in two (the second 45% full); N = 2,304 (qkv) 396 tiles
// in three waves against 576 in five; N = 3,072 (MLP1) ties at 768 rows, and
// so do SAM's window blocks at M = 7,448 and N = 768 or 2,304. 128-row tiles
// are faster only at small one-wave launches (ModelConfig's default ViT at
// ~1,009 rows, by 0.7 us a launch), which no benchmark cell runs.
//
// Layouts: x (M, K) float32, rows adjacent, 16-byte aligned; the packed
// weights [N / 128 tiles][K / 32 stages][hi, lo][4 k-steps][the 128 x 8 B
// tile: 16 row groups][2 k halves][8 rows][4] floats, k-step q holding the
// stage's inputs 4q .. 4q + 3 and 16 + 4q .. 16 + 4q + 3; bias (N) or null;
// y (M, N).
#include <cstdint>

#include <cuda.h>
#include <cudaTypedefs.h>

#include "pmc_common.cuh"

namespace {

using pmc::b_desc;
using pmc::bulk_copy;
using pmc::mbar_expect;
using pmc::mbar_init;
using pmc::mbar_wait;
using pmc::smem_u32;
using pmc::split;
using pmc::wgmma_commit;
using pmc::wgmma_fence;
using pmc::wgmma_tf32;
using pmc::wgmma_wait_pending;

constexpr int kBN = 128;  // output columns of a tile: one wgmma's N
constexpr int kBK = 32;   // inputs of a stage: one 128-byte row of x
constexpr int kKS = kBK / 8;  // k-steps of a stage
constexpr int kBufs = 4;   // stages in the ring
constexpr int kAhead = 2;  // stages loaded ahead of the products
constexpr int kTileFloats = kBN * 8;             // a k-step's B tile
constexpr int kBFloats = 2 * kKS * kTileFloats;  // a stage's hi and lo
constexpr int kAlign = 1024;  // of a 128-byte-swizzled TMA tile
constexpr float kSqrt1_2 = 0.70710678118654752440f;

static_assert(kKS == 4, "a k-step reads 16-byte units q and q + 4 of a row");

// Keeps the compiler from moving a read of the accumulator above the wait
// that completes it.
__device__ __forceinline__ void fence_accumulator(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}
// the box of `map` at (column c, row r) into shared memory, reported to bar
__device__ __forceinline__ void tensor_copy(void* dst, const CUtensorMap* map,
                                            int c, int r, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c),
         "r"(r), "r"(smem_u32(bar))
      : "memory");
}

constexpr int kBM = 192;  // rows of a tile: three warpgroups of 64
constexpr int kWarps = kBM / 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kAFloats = kBM * kBK;  // a stage's rows
constexpr int kStageBytes =
    (kBFloats + kAFloats) * static_cast<int>(sizeof(float));
constexpr int kSmemBytes = kAlign + kBufs * kStageBytes +
                           2 * kBufs * static_cast<int>(sizeof(uint64_t));
static_assert(kSmemBytes <= 232448, "the ring fits a block's shared memory");
static_assert(kAFloats * sizeof(float) % kAlign == 0, "aligned A tiles");

__global__ void __launch_bounds__(kThreads, 1)
    dense_gemm_kernel(const __grid_constant__ CUtensorMap x_map,
                      const float* __restrict__ packed,
                      const float* __restrict__ bias, float* __restrict__ y,
                      int M, int K, int N, int gelu) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  float* s_a = reinterpret_cast<float*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + kAlign - 1) &
      ~static_cast<uintptr_t>(kAlign - 1));           // the stages' rows
  float* s_b = s_a + kBufs * kAFloats;             // the stages' weights
  uint64_t* full = reinterpret_cast<uint64_t*>(s_b + kBufs * kBFloats);
  uint64_t* empty = full + kBufs;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  // this lane's rows of the tile: m and m + 8
  const int m = 64 * (warp >> 2) + 16 * (warp & 3) + g;

  // the tile: (row tile, column tile), the column tiles fastest, so the
  // blocks that read the same rows run together and meet in L2
  const int n_tiles = N / kBN;
  const int nt = blockIdx.x % n_tiles;
  const int m0 = blockIdx.x / n_tiles * kBM;
  const int n0 = nt * kBN;
  const int stages = K / kBK;
  const float* wp = packed + static_cast<long long>(nt) * stages * kBFloats;

  // full[b]: stage s (b = s % 4) has arrived, its weights and rows by two
  // bulk copies; empty[b]: every warp's products of it have completed
  if (threadIdx.x == 0) {
    for (int i = 0; i < kBufs; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  // stage s by thread 0: its weights and its rows' inputs 32 s .. 32 s + 31
  // (the tensor map zero-fills the rows past M), into buffer s % 4 once the
  // products of stage s - 4 there have completed
  const auto load = [&](int s) {
    const int buf = s % kBufs;
    if (s >= kBufs) mbar_wait(empty + buf, (s / kBufs - 1) & 1);
    mbar_expect(full + buf, kStageBytes);
    bulk_copy(s_b + buf * kBFloats, wp + static_cast<long long>(s) * kBFloats,
              kBFloats * static_cast<int>(sizeof(float)), full + buf);
    tensor_copy(s_a + buf * kAFloats, &x_map, s * kBK, m0, full + buf);
  };
  if (threadIdx.x == 0)
    for (int s = 0; s < kAhead && s < stages; ++s) load(s);

  float sum[64];  // as d: rows m, m + 8; columns 8j + 2t, 8j + 2t + 1
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    const int n = n0 + 8 * j + 2 * t;
    const float e0 = bias ? bias[n] : 0.f;
    const float e1 = bias ? bias[n + 1] : 0.f;
    sum[4 * j] = sum[4 * j + 2] = e0;
    sum[4 * j + 1] = sum[4 * j + 3] = e1;
  }
  // the accumulator of a stage's products (the first of them starts it
  // from zero: a write of it here would serialize the products)
  float d[64];
  uint32_t ah[2][4], al[2][4];

  for (int s = 0; s < stages; ++s) {
    const int buf = s % kBufs;
    if (threadIdx.x == 0 && s + kAhead < stages) load(s + kAhead);
    mbar_wait(full + buf, (s / kBufs) & 1);

    const float* sa = s_a + buf * kAFloats;
    const float* sb = s_b + buf * kBFloats;
#pragma unroll
    for (int q = 0; q < kKS; ++q) {
      const int set = q & 1;
      // register set `set` was last read by k-step q - 2 (of the previous
      // stage for q < 2): all but the newest commit group are complete
      wgmma_wait_pending<1>();
      // so, at q = 1, are the previous stage's products: its buffer is free
      if (q == 1 && s > 0 && lane == 0) mbar_arrive(empty + (s - 1) % kBufs);
      // A: k-step q reads 16-byte units q and q + 4 of the rows (swizzled by
      // the copy: unit u of row r lies at u ^ (r % 8)); lane t its floats
      // 2 (t % 2), + 1 of unit q + 4 (t / 2) as k-indices t and t + 4
      const int u = (q + 4 * (t >> 1)) ^ (m & 7), f = 2 * (t & 1);
      const float2 e =
          *reinterpret_cast<const float2*>(sa + m * kBK + 4 * u + f);
      const float2 o =
          *reinterpret_cast<const float2*>(sa + (m + 8) * kBK + 4 * u + f);
      split(e.x, ah[set][0], al[set][0]);
      split(o.x, ah[set][1], al[set][1]);
      split(e.y, ah[set][2], al[set][2]);
      split(o.y, ah[set][3], al[set][3]);
      if (q == 0) {
        // the previous stage's products are complete: their sum goes to
        // the float32 sums
        wgmma_wait_pending<0>();
        fence_accumulator(d);
        if (s > 0) {
#pragma unroll
          for (int i = 0; i < 64; ++i) sum[i] += d[i];
        }
      }
      wgmma_fence();
      const float* hi = sb + q * kTileFloats;
      const float* lo = hi + kKS * kTileFloats;
      wgmma_tf32(d, al[set], b_desc(hi), q != 0);
      wgmma_tf32(d, ah[set], b_desc(lo), 1);
      wgmma_tf32(d, ah[set], b_desc(hi), 1);
      wgmma_commit();
    }
  }
  // the last stage's products
  wgmma_wait_pending<0>();
  fence_accumulator(d);
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    float v = sum[i] + d[i];
    if (gelu) v = v * 0.5f * (1.f + erff(v * kSqrt1_2));
    sum[i] = v;
  }

  // row m0 + m (+ 8), columns n0 + 8j + 2t, + 1
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = m0 + m + 8 * half;
    if (row >= M) continue;
    float* dst = y + static_cast<long long>(row) * N + n0 + 2 * t;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j)
      *reinterpret_cast<float2*>(dst + 8 * j) =
          make_float2(sum[4 * j + 2 * half], sum[4 * j + 2 * half + 1]);
  }
}

// cuTensorMapEncodeTiled from the driver (no link to libcuda), or null
PFN_cuTensorMapEncodeTiled_v12000 encode_tiled() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

}  // namespace

// x: (M, K) float32, rows adjacent, 16-byte aligned; packed: W (N, K) as
// pack_weight lays it out; bias: (N) or null; y: (M, N); gelu: nonzero for
// exact GELU after the bias. Takes M >= 1, K a multiple of 32 and N of 128;
// returns cudaErrorInvalidValue for other shapes and for a grid it cannot
// hold, else cudaGetLastError() after the launch.
extern "C" int pmc_dense_gemm(const float* x, const float* packed,
                              const float* bias, float* y, int M, int K,
                              int N, int gelu, void* stream) {
  if (M < 1 || K < kBK || K % kBK || N < kBN || N % kBN)
    return cudaErrorInvalidValue;
  const long long blocks =
      static_cast<long long>((M + kBM - 1) / kBM) * (N / kBN);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  // x as (M, K) boxes of kBM rows x 32 floats (one 128-byte row each),
  // 128-byte swizzled, zeros past row M
  const auto encode = encode_tiled();
  if (!encode) return cudaErrorNotSupported;
  CUtensorMap map;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K),
                              static_cast<cuuint64_t>(M)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(K) * sizeof(float)};
  const cuuint32_t box[2] = {kBK, kBM};
  const cuuint32_t steps[2] = {1, 1};
  if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(x),
             dims, strides, box, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  const cudaError_t e = cudaFuncSetAttribute(
      dense_gemm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (e != cudaSuccess) return e;
  dense_gemm_kernel<<<static_cast<unsigned>(blocks), kThreads, kSmemBytes,
                      static_cast<cudaStream_t>(stream)>>>(
      map, packed, bias, y, M, K, N, gelu);
  return cudaGetLastError();
}
