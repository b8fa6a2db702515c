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

// wgmma (m64n128k8, TF32) with B from shared memory, and bulk copies (TMA)
// reported to an mbarrier (projection_conv.cu, dense_gemm.cu)
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The shared-memory descriptor of a B tile: no swizzle, the two K-adjacent
// core matrices 128 bytes apart (leading byte offset), row groups of 8
// 256 bytes apart (stride byte offset).
__device__ __forceinline__ uint64_t b_desc(const float* p) {
  const uint32_t a = smem_u32(p);
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(128 >> 4) << 16) |
         (static_cast<uint64_t>(256 >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// waits until at most N of this warpgroup's committed groups are pending
template <int N>
__device__ __forceinline__ void wgmma_wait_pending() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// a barrier whose phase `count` arrivals (and the bytes they announce)
// complete
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count = 1) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}
// the barrier's current phase completes when `bytes` more have arrived
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}
// one bulk copy (TMA) of `bytes`, a multiple of 16, from global into shared
// memory, its bytes reported to the barrier
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}
// one bulk copy whose bytes alone complete the barrier's phase
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  mbar_expect(bar, bytes);
  bulk_copy(dst, src, bytes, bar);
}
// waits for the phase of the barrier whose parity is `parity`
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
}

// d (64 x 128) (+)= a (64 x 8, TF32 registers) . B (8 x 128 at desc); the
// sum starts from zero where add is 0
__device__ __forceinline__ void wgmma_tf32(float (&d)[64],
                                           const uint32_t (&a)[4],
                                           uint64_t desc, int add) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(add));
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
