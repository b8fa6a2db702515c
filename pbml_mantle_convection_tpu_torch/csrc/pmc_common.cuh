// Shared declarations of the package's CUDA kernels (sm_90a).
//
// Fields are dense planar float32 tensors (C, H, W) of one simulation:
// element (c, r, col) lies at (c * H + r) * W + col. Every C entry point
// launches on the stream it is given, allocates nothing, does not
// synchronise, and returns cudaGetLastError().
#pragma once

#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace pmc {

// Fields (pyramid levels) one layer launch takes; also the most coarse
// branches the trunk upsamples.
constexpr int kMaxLevels = 5;
// Devices whose co-resident block counts are cached.
constexpr int kMaxDevices = 64;

// Internal linkage: every .cu file compiles its own copies.
namespace {

// TF32 tensor-core products (blc_layer.cuh, slice_attention.cu,
// dense_attention.cu). A float x splits as hi = to_tf32(x),
// lo = to_tf32(x - hi); the 3xTF32 sum a_lo*b_hi + a_hi*b_lo + a_hi*b_hi
// in float32 is float32-accurate.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// D (16x8) += A (16x8, row) . B (8x8, col); lane (g = lane / 4,
// t = lane % 4) holds a = A[g][t], A[g+8][t], A[g][t+4], A[g+8][t+4],
// b = B[t][g], B[t+4][g], and d = D[g][2t], D[g][2t+1], D[g+8][2t],
// D[g+8][2t+1].
__device__ __forceinline__ void mma_tf32(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// x = hi + lo: hi rounded to TF32 by integer ops (cvt.rna costs more), lo
// passed whole (the tensor cores read the top 19 bits of a TF32 operand)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d += a . b in 3xTF32: the small terms first
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint32_t bh0,
                                     uint32_t bh1, uint32_t bl0,
                                     uint32_t bl1) {
  mma_tf32(d, al[0], al[1], al[2], al[3], bh0, bh1);
  mma_tf32(d, ah[0], ah[1], ah[2], ah[3], bl0, bl1);
  mma_tf32(d, ah[0], ah[1], ah[2], ah[3], bh0, bh1);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}
// 16 bytes from src, or (valid false) 16 zero bytes and nothing read
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src,
                                                 bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
// waits until at most n (0 to 3; more counts as 3) of this thread's
// committed groups are still in flight
__device__ __forceinline__ void cp_async_wait_pending(int n) {
  if (n <= 0)
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  else if (n == 1)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else if (n == 2)
    asm volatile("cp.async.wait_group 2;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 3;\n" ::: "memory");
}

// Blocks of `threads` threads of `kernel` that the card holds at once
// (resident blocks per SM x SMs): the largest grid whose blocks can all
// wait for each other, as a cooperative launch requires. Queried once per
// kernel and device.
template <typename Kernel>
cudaError_t coresident_blocks(Kernel kernel, int threads, int* blocks) {
  static int cache[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (cache[dev] == 0) {
    int per_sm = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, 0);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
    cache[dev] = per_sm * sms;
  }
  *blocks = cache[dev];
  return cudaSuccess;
}

// A cooperative launch (cooperative_groups::this_grid().sync() allowed):
// the runtime refuses it, rather than hang, if the grid exceeds what the
// card holds at once. A stream capture records it as a cooperative kernel
// node.
template <typename... Params, typename... Args>
cudaError_t launch_cooperative(void (*kernel)(Params...), int blocks,
                               int threads, cudaStream_t stream,
                               const Args&... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

}  // namespace
}  // namespace pmc
