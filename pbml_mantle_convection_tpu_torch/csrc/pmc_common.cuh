// Shared declarations of the package's CUDA kernels (sm_90a).
//
// Fields are dense planar float32 tensors (C, H, W) of one simulation:
// element (c, r, col) lies at (c * H + r) * W + col. Every C entry point
// launches on the stream it is given, allocates nothing, does not
// synchronise, and returns cudaGetLastError().
#pragma once

#include <cuda_runtime.h>

namespace pmc {

// Partial-sum blocks per GroupNorm group (gn_stats_kernel's grid.x); the
// caller's `stats` scratch holds groups * kGnStatsBlocks * 2 doubles.
constexpr int kGnStatsBlocks = 32;
constexpr int kMaxGroups = 16;

// One learned-boundary FluidLayer, y = act(GN(blc_conv(x) + bias)):
//   x (c_in, H, W) → y (c_o, H, W); w packed as (9, c_in, 25, c_o) in the
//   class order of models/layers.py::BLC_CLASSES; bias/gn_scale/gn_bias
//   (c_o). use_gn = 0 skips the GroupNorm, use_act = 0 the GELU.
cudaError_t blc_layer(const float* x, float* y, double* stats,
                      const float* w, const float* bias,
                      const float* gn_scale, const float* gn_bias,
                      int c_in, int c_o, int H, int W, int groups,
                      int use_gn, int use_act, cudaStream_t stream);

}  // namespace pmc
