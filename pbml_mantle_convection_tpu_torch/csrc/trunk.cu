// trunk: bicubic upsampling of the coarse branches + the merge-1 layer.
//
// Replaces the TPU kernel pbml_mantle_convection_tpu/ops/merge_kernel.py::
// _trunk_kernel (built by TrunkStack). It assembles the merge input of
// NewFluidNet — branch 0 (c_h), the coarse branches 1..L-1 bicubic-upsampled
// to H x W (c_h each) and the c_x-channel network input, 87 channels for
// the flagship — and runs the merge-1 learned-boundary conv 87 -> c_h with
// bias, GroupNorm (c_h/4 groups) and exact GELU through the layer_stack
// code path (layer_stack.cu).
//
// The upsampling is the matrix of ops/resize.py::_resize_matrix_np (Keys
// a = -0.75, half-pixel centres, clamped source indices), applied from
// per-row and per-column tables of its 4 non-zero taps, which the wrapper
// takes from that float64 matrix. Each output element sums the 4x4 taps,
// rows first, then columns, as the JAX einsums order them.
//
// What bounds it: operations — the 87->16 conv is 4.5 GFLOP at 128x506,
// against ~30 MB of traffic for the concat buffer. Design: one elementwise
// pass writes every channel slice of a dense (87, H, W) buffer (the copy of
// branch 0 and of the input is 6 MB, ~2 us at 3.35 TB/s), then the tiled
// conv of layer_stack.cu reads it. Later work: read the coarse branches
// straight from the conv's shared-memory stage and skip the buffer.
#include "pmc_common.cuh"

namespace {

constexpr int kMaxCoarse = 8;

struct CoarseSet {
  const float* p[kMaxCoarse];
  int h[kMaxCoarse];
  int w[kMaxCoarse];
};

__global__ void __launch_bounds__(256)
trunk_assemble_kernel(const float* __restrict__ b0, CoarseSet cs,
                      const float* __restrict__ x, float* __restrict__ cat,
                      const int* __restrict__ yi, const float* __restrict__ yw,
                      const int* __restrict__ xi, const float* __restrict__ xw,
                      int c_h, int n_coarse, int c_x, int H, int W) {
  const size_t HW = (size_t)H * W;
  const int c_branch = c_h * (n_coarse + 1);
  const size_t total = (size_t)(c_branch + c_x) * HW;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const int ch = (int)(i / HW);
    const size_t pix = i - (size_t)ch * HW;
    float v;
    if (ch < c_h) {
      v = __ldg(&b0[i]);
    } else if (ch < c_branch) {
      const int l = ch / c_h - 1;
      const int cc = ch - (l + 1) * c_h;
      const int r = (int)(pix / W), c = (int)(pix - (size_t)r * W);
      const int wl = cs.w[l];
      const float* src = cs.p[l] + (size_t)cc * cs.h[l] * wl;
      const size_t ty = ((size_t)l * H + r) * 4, tx = ((size_t)l * W + c) * 4;
      v = 0.f;
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int col = __ldg(&xi[tx + b]);
        float s = 0.f;
#pragma unroll
        for (int a = 0; a < 4; ++a)
          s += __ldg(&yw[ty + a]) * __ldg(&src[(size_t)__ldg(&yi[ty + a]) * wl + col]);
        v += __ldg(&xw[tx + b]) * s;
      }
    } else {
      v = __ldg(&x[(size_t)(ch - c_branch) * HW + pix]);
    }
    cat[i] = v;
  }
}

}  // namespace

extern "C" int pmc_trunk(const float* b0, const void* const* coarse,
                         const int* coarse_hw, int n_coarse, const float* x,
                         int c_x, float* cat, float* y, double* stats,
                         const int* yi, const float* yw, const int* xi,
                         const float* xw, const float* w, const float* bias,
                         const float* gn_scale, const float* gn_bias, int c_h,
                         int H, int W, int groups, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (n_coarse < 0 || n_coarse > kMaxCoarse) return cudaErrorInvalidValue;
  CoarseSet cs{};
  for (int l = 0; l < n_coarse; ++l) {
    cs.p[l] = static_cast<const float*>(coarse[l]);
    cs.h[l] = coarse_hw[2 * l];
    cs.w[l] = coarse_hw[2 * l + 1];
  }
  const int c_in = c_h * (n_coarse + 1) + c_x;
  const size_t total = (size_t)c_in * H * W;
  size_t blocks = (total + 255) / 256;
  if (blocks > 8192) blocks = 8192;
  trunk_assemble_kernel<<<(int)blocks, 256, 0, stream>>>(
      b0, cs, x, cat, yi, yw, xi, xw, c_h, n_coarse, c_x, H, W);
  const cudaError_t err = pmc::blc_layer(cat, y, stats, w, bias, gn_scale,
                                         gn_bias, c_in, c_h, H, W, groups, 1,
                                         1, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
