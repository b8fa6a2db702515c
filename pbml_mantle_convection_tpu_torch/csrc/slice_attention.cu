// slice_pool / slice_deslice: the Physics-Attention core of the Transolver.
//
// Replaces the TPU kernels pbml_mantle_convection_tpu/ops/slice_attention.py::
// _pool_kernel and ::_deslice_kernel (slice_attention_fused). For each
// (batch, head) pair bh and each point n, with x = x_mid[bh, n, :] (D values)
// and G slices:
//   w[n, g] = softmax_g((x . ws[:, g] + bs[g]) / temp[bh])
//   slice_pool     num[bh, g, d] = sum_n w[n, g] fx[bh, n, d]
//                  den[bh, g]    = sum_n w[n, g]
//   slice_deslice  out[bh, n, d] = sum_g w[n, g] tok[bh, g, d]
// The (BH, N, G) weights never reach device memory: each kernel recomputes
// them from x_mid, as the Pallas kernels do.
//
// What bounds it: at the serving shape (BH = 8, N = 64,768, D = 16, G = 32)
// bytes: each kernel streams two (BH, N, D) float32 arrays, 66 MB, for
// ~1.1 GFLOP of multiply-adds. At D = 32, G = 64 operations (4.2 GFLOP).
//
// Design: a block of kThreads threads takes tiles of P points. A tile of
// x_mid (and of fx) is one contiguous run of P * D values: the block loads
// it into shared memory coalesced, in rows padded to D + 1 (no bank
// conflicts when each thread reads its own row). Thread t < P computes the
// G logits of point t and their max-subtracted softmax into a shared
// (P, G + 1) weight tile. Then every thread works on the tile's products,
// consecutive threads on consecutive outputs.
//   slice_pool: each block walks `tiles_per_chunk` tiles of one bh and keeps
//   its share of the (G, D + 1) sums in registers (column D of the fx tile
//   is 1, so that column sums the weights: den). A one-block-per-bh second
//   pass adds the chunks in a fixed order. No float atomics: repeated calls
//   give the same bits. The tail of N is masked, not padded, so den needs
//   no correction for padded rows.
//   slice_deslice: one tile per block; the attended tokens (G, D) are staged
//   in shared memory and the (P, D) output tile is written coalesced.
// Templated on float and double (accumulation in the input type). D and G
// are runtime values up to kMaxDim; P is 128 in float, 64 in double, so the
// largest shared-memory request stays under the 227 KB of a block.
#include "pmc_common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxDim = 64;
// registers per thread for the (G, D + 1) sums of slice_pool
constexpr int kMaxAcc = (kMaxDim * (kMaxDim + 1) + kThreads - 1) / kThreads;
constexpr int kDefaultSmem = 48 * 1024;

template <typename T>
struct Tile;
template <>
struct Tile<float> {
  static constexpr int P = 128;
};
template <>
struct Tile<double> {
  static constexpr int P = 64;
};

__device__ __forceinline__ float texp(float x) { return expf(x); }
__device__ __forceinline__ double texp(double x) { return exp(x); }

// Copies rows [0, nv) of a (rows, D) run of global memory into shared rows
// of stride D + 1.
template <typename T>
__device__ void load_rows(const T* __restrict__ src, int nv, int D,
                          T* __restrict__ dst) {
  for (int i = threadIdx.x; i < nv * D; i += kThreads) {
    const int r = i / D;
    dst[r * (D + 1) + (i - r * D)] = __ldg(&src[i]);
  }
}

template <typename T>
__device__ void load_flat(const T* __restrict__ src, int n,
                          T* __restrict__ dst) {
  for (int i = threadIdx.x; i < n; i += kThreads) dst[i] = __ldg(&src[i]);
}

// Softmax weights of the tile's nv points: row t of sw (stride G + 1) from
// row t of sx (stride D + 1). The expressions of jax.nn.softmax: logits
// (x . ws + bs) / temp, minus their max, exp, divided by the sum. Ends with
// a barrier.
template <typename T>
__device__ void tile_weights(const T* __restrict__ sx,
                             const T* __restrict__ sws,
                             const T* __restrict__ sbs, T temp, int nv, int D,
                             int G, T* __restrict__ sw) {
  const int t = threadIdx.x;
  if (t < nv) {
    const T* x = sx + t * (D + 1);
    T* row = sw + t * (G + 1);
    T mx = T(0);
    for (int g = 0; g < G; ++g) {
      T acc = T(0);
      for (int d = 0; d < D; ++d) acc += x[d] * sws[d * G + g];
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
slice_pool_kernel(const T* __restrict__ fx, const T* __restrict__ xm,
                  const T* __restrict__ ws, const T* __restrict__ bs,
                  const T* __restrict__ temp, int N, int D, int G,
                  int tiles_per_chunk, T* __restrict__ part) {
  constexpr int P = Tile<T>::P;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sws = reinterpret_cast<T*>(smem_raw);  // (D, G)
  T* sbs = sws + D * G;                     // (G)
  T* sx = sbs + G;                          // (P, D + 1)
  T* sf = sx + P * (D + 1);                 // (P, D + 1), column D = 1
  T* sw = sf + P * (D + 1);                 // (P, G + 1)
  const int bh = blockIdx.y, chunk = blockIdx.x;
  const int GD1 = G * (D + 1);
  load_flat(ws, D * G, sws);
  load_flat(bs, G, sbs);
  for (int r = threadIdx.x; r < P; r += kThreads) sf[r * (D + 1) + D] = T(1);
  const T tb = temp[bh];
  const size_t base = static_cast<size_t>(bh) * N * D;

  T acc[kMaxAcc];
#pragma unroll
  for (int k = 0; k < kMaxAcc; ++k) acc[k] = T(0);

  for (int it = 0; it < tiles_per_chunk; ++it) {
    const int n0 = (chunk * tiles_per_chunk + it) * P;
    if (n0 >= N) break;  // the same for every thread of the block
    const int nv = min(P, N - n0);
    __syncthreads();  // the last tile's products are done with sx, sf, sw
    load_rows(xm + base + static_cast<size_t>(n0) * D, nv, D, sx);
    load_rows(fx + base + static_cast<size_t>(n0) * D, nv, D, sf);
    __syncthreads();
    tile_weights(sx, sws, sbs, tb, nv, D, G, sw);
#pragma unroll
    for (int k = 0; k < kMaxAcc; ++k) {
      const int o = threadIdx.x + k * kThreads;
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
  for (int k = 0; k < kMaxAcc; ++k) {
    const int o = threadIdx.x + k * kThreads;
    if (o < GD1) out[o] = acc[k];
  }
}

// Adds the chunks' (G, D + 1) sums of one bh in chunk order.
template <typename T>
__global__ void __launch_bounds__(256)
slice_pool_reduce_kernel(const T* __restrict__ part, int chunks, int D, int G,
                         T* __restrict__ num, T* __restrict__ den) {
  const int bh = blockIdx.x, GD1 = G * (D + 1);
  const T* p = part + static_cast<size_t>(bh) * chunks * GD1;
  for (int o = threadIdx.x; o < GD1; o += blockDim.x) {
    T s = T(0);
    for (int c = 0; c < chunks; ++c) s += p[static_cast<size_t>(c) * GD1 + o];
    const int g = o / (D + 1), d = o - g * (D + 1);
    if (d < D)
      num[(static_cast<size_t>(bh) * G + g) * D + d] = s;
    else
      den[static_cast<size_t>(bh) * G + g] = s;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
slice_deslice_kernel(const T* __restrict__ xm, const T* __restrict__ tok,
                     const T* __restrict__ ws, const T* __restrict__ bs,
                     const T* __restrict__ temp, int N, int D, int G,
                     T* __restrict__ out) {
  constexpr int P = Tile<T>::P;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sws = reinterpret_cast<T*>(smem_raw);  // (D, G)
  T* sbs = sws + D * G;                     // (G)
  T* stok = sbs + G;                        // (G, D)
  T* sx = stok + G * D;                     // (P, D + 1)
  T* sw = sx + P * (D + 1);                 // (P, G + 1)
  const int bh = blockIdx.y, n0 = blockIdx.x * P;
  const int nv = min(P, N - n0);
  const size_t base = (static_cast<size_t>(bh) * N + n0) * D;
  load_flat(ws, D * G, sws);
  load_flat(bs, G, sbs);
  load_flat(tok + static_cast<size_t>(bh) * G * D, G * D, stok);
  load_rows(xm + base, nv, D, sx);
  __syncthreads();
  tile_weights(sx, sws, sbs, temp[bh], nv, D, G, sw);
  for (int i = threadIdx.x; i < nv * D; i += kThreads) {
    const int n = i / D, d = i - n * D;
    const T* w = sw + n * (G + 1);
    T s = T(0);
    for (int g = 0; g < G; ++g) s += w[g] * stok[g * D + d];
    out[base + i] = s;
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

bool dims_ok(int BH, int N, int D, int G) {
  return BH >= 1 && BH <= 65535 && N >= 1 && D >= 1 && G >= 1 &&
         D <= kMaxDim && G <= kMaxDim;
}

template <typename T>
int slice_pool(const T* fx, const T* xm, const T* ws, const T* bs,
               const T* temp, T* part, T* num, T* den, int BH, int N, int D,
               int G, int chunks, int tiles_per_chunk, void* stream_ptr) {
  constexpr int P = Tile<T>::P;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const long long tiles = (static_cast<long long>(N) + P - 1) / P;
  // every chunk holds at least one tile, and the chunks cover them all
  if (!dims_ok(BH, N, D, G) || chunks < 1 || tiles_per_chunk < 1 ||
      static_cast<long long>(chunks) * tiles_per_chunk < tiles ||
      static_cast<long long>(chunks - 1) * tiles_per_chunk >= tiles)
    return cudaErrorInvalidValue;
  const size_t smem =
      sizeof(T) * (D * G + G + 2 * P * (D + 1) + P * (G + 1));
  cudaError_t e = allow_smem(slice_pool_kernel<T>, smem);
  if (e != cudaSuccess) return e;
  slice_pool_kernel<T><<<dim3(chunks, BH), kThreads, smem, stream>>>(
      fx, xm, ws, bs, temp, N, D, G, tiles_per_chunk, part);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  slice_pool_reduce_kernel<T><<<BH, 256, 0, stream>>>(part, chunks, D, G,
                                                      num, den);
  return cudaGetLastError();
}

template <typename T>
int slice_deslice(const T* xm, const T* tok, const T* ws, const T* bs,
                  const T* temp, T* out, int BH, int N, int D, int G,
                  void* stream_ptr) {
  constexpr int P = Tile<T>::P;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (!dims_ok(BH, N, D, G)) return cudaErrorInvalidValue;
  const size_t smem =
      sizeof(T) * (D * G + G + G * D + P * (D + 1) + P * (G + 1));
  cudaError_t e = allow_smem(slice_deslice_kernel<T>, smem);
  if (e != cudaSuccess) return e;
  const int tiles = (N + P - 1) / P;
  slice_deslice_kernel<T><<<dim3(tiles, BH), kThreads, smem, stream>>>(
      xm, tok, ws, bs, temp, N, D, G, out);
  return cudaGetLastError();
}

}  // namespace

// fx, xm (BH, N, D); ws (D, G); bs (G); temp (BH); part scratch of
// BH * chunks * G * (D + 1) values; num (BH, G, D); den (BH, G). The chunks
// split the ceil(N / P) tiles of a bh, tiles_per_chunk each (the last one
// may hold fewer), P = Tile<T>::P.
#define PMC_SLICE_ENTRIES(SUFFIX, T)                                          \
  extern "C" int pmc_slice_pool_##SUFFIX(                                     \
      const T* fx, const T* xm, const T* ws, const T* bs, const T* temp,      \
      T* part, T* num, T* den, int BH, int N, int D, int G, int chunks,       \
      int tiles_per_chunk, void* stream) {                                    \
    return slice_pool<T>(fx, xm, ws, bs, temp, part, num, den, BH, N, D, G,   \
                         chunks, tiles_per_chunk, stream);                    \
  }                                                                           \
  extern "C" int pmc_slice_deslice_##SUFFIX(                                  \
      const T* xm, const T* tok, const T* ws, const T* bs, const T* temp,     \
      T* out, int BH, int N, int D, int G, void* stream) {                    \
    return slice_deslice<T>(xm, tok, ws, bs, temp, out, BH, N, D, G, stream); \
  }

PMC_SLICE_ENTRIES(f32, float)
PMC_SLICE_ENTRIES(f64, double)
