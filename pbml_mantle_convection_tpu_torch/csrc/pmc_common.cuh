// Shared declarations of the package's CUDA kernels (sm_90a).
//
// Fields are dense planar float32 tensors (C, H, W) of one simulation:
// element (c, r, col) lies at (c * H + r) * W + col. Every C entry point
// launches on the stream it is given, allocates nothing, does not
// synchronise, and returns cudaGetLastError().
#pragma once

#include <cuda_runtime.h>

namespace pmc {

// Fields (pyramid levels) one layer launch takes; also the most coarse
// branches the trunk upsamples.
constexpr int kMaxLevels = 5;

}  // namespace pmc
