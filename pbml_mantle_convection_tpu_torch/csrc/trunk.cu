// trunk: bicubic upsampling of the coarse branches + the merge-1 layer.
//
// Replaces the TPU kernel pbml_mantle_convection_tpu/ops/merge_kernel.py::
// _trunk_kernel (built by TrunkStack). Its input is NewFluidNet's merge
// input — branch 0 (c_h), the coarse branches 1..L-1 bicubic-upsampled to
// H x W (c_h each) and the c_x-channel network input, 87 channels for the
// flagship — and it runs the merge-1 conv 87 -> c_h with bias, GroupNorm
// (c_h/4 groups) and the activation `act` (blc_layer.cuh::Act, 1-7: exact
// GELU or another of the seven): the learned-boundary conv (learned=True)
// or, with zero_pad, the zero-padded SAME conv (learned=False; the
// upsampled branches and the skip channels read 0 outside the field).
//
// What bounds it: operations — the 87->16 conv is 4.5 GFLOP at 128x506
// (13.5 as 3xTF32 tensor-core work). Design: the layer kernel of
// blc_layer.cuh (implicit GEMM on the tensor cores, 3xTF32, the ring as
// work items of the same launch, GroupNorm statistics by the last block)
// with its K loop over the 11 eight-channel chunks of the 87 (padded to
// 88) staged straight from the sources: branch 0 and the network input
// are read directly; a coarse branch is upsampled in the staging step —
// rows first into shared memory for the coarse columns the tile reads,
// then columns — from the per-row and per-column tables of the 4 non-zero
// taps of ops/resize.py::_resize_matrix_np (Keys a = -0.75, half-pixel
// centres, clamped source indices), summed in the order of the JAX
// einsums. No (87, H, W) buffer is written. Then one gn_apply_kernel pass:
// 2 launches per call.
#include "blc_layer.cuh"

extern "C" int pmc_trunk(const float* b0, const void* const* coarse,
                         const int* coarse_hw, int n_coarse, const float* x,
                         int c_x, float* y, float* stats, double* partial,
                         int* counter, const int* yi, const float* yw,
                         const int* xi, const float* xw, const float* frag,
                         const float* bias, const float* gn_scale,
                         const float* gn_bias, int c_h, int H, int W,
                         int groups, int act, int zero_pad,
                         void* stream_ptr) {
  using namespace pmc;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int min_hw = zero_pad ? 1 : 6;
  if (n_coarse < 0 || n_coarse > kMaxLevels || c_h < 8 || c_h > kMaxCo ||
      c_h % 8 || c_x < 0 || H < min_hw || W < min_hw || groups < 1 ||
      c_h % groups || act == kActNone || !valid_act(act))
    return cudaErrorInvalidValue;
  TrunkSrc t{};
  t.b0 = b0;
  for (int l = 0; l < n_coarse; ++l) {
    t.coarse[l] = static_cast<const float*>(coarse[l]);
    t.ch[l] = coarse_hw[2 * l];
    t.cw[l] = coarse_hw[2 * l + 1];
  }
  t.x = x;
  t.yi = yi;
  t.yw = yw;
  t.xi = xi;
  t.xw = xw;
  t.n_coarse = n_coarse;
  t.c_h = c_h;
  t.c_x = c_x;

  LayerArgs a{};
  a.n_levels = 1;
  a.c_in = c_h * (n_coarse + 1) + c_x;
  a.c_o = c_h;
  a.groups = groups;
  a.gn_out = 1;
  a.act_out = 1;
  LayerLevel& v = a.lv[0];
  v.y = y;
  v.frag = frag;
  v.bias = bias;
  v.stats_out = stats;
  v.partial = partial;
  v.counter = counter;
  v.H = H;
  v.W = W;
  cudaError_t err = launch_layer<true>(a, t, zero_pad != 0, act, stream);
  if (err != cudaSuccess) return err;

  ApplyArgs p{};
  p.n_levels = 1;
  p.c_o = c_h;
  p.groups = groups;
  p.act = 1;
  p.lv[0].y = y;
  p.lv[0].stats = stats;
  p.lv[0].scale = gn_scale;
  p.lv[0].shift = gn_bias;
  p.lv[0].H = H;
  p.lv[0].W = W;
  err = launch_apply(p, act, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}
