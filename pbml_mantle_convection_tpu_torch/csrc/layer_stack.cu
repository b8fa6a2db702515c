// layer_stack: stacks of R FluidLayers on the card, one field or up to
// five pyramid levels at once.
//
// Replaces the TPU kernel pbml_mantle_convection_tpu/ops/branch_kernel.py::
// _stack_kernel (built by LayerStack), every instance of it. Per layer:
// a 5x5 conv, then bias, GroupNorm over the whole field (eps 1e-5), and
// the activation `act`: exact-erf GELU or any other of the seven of the
// JAX package's models/layers.py (blc_layer.cuh::activate, the template
// parameter ACT of each kernel). learned=True: the learned-boundary conv, whose weight
// set and input window depend on where the output pixel lies (the
// interior `conv`, the 4 edge and 4 corner convs of the learned padding,
// with the reference's row flip: output rows 0-1 read input rows
// H-6..H-1 through the conv_bottom* weights, rows H-2..H-1 read rows 0..5
// through conv_top*) and its learnable bias. learned=False: a SAME conv
// over the zero-padded field and the conv's own bias (blc_layer.cuh's
// ZERO instance: 8x32 tiles over the whole field, no ring items).
//
// What bounds it: operations. A 16->16 layer at 128x506 is 0.83 GFLOP;
// the step's stacks are ~3.6 GFLOP, 3x that as 3xTF32 tensor-core work.
// The TPU kernel keeps the field in VMEM across its R layers; on Hopper the
// field does not fit one SM but does fit the 50 MB L2 (4.1 MB at level 0),
// so the design keeps each layer to one launch and one pass over its input:
// - blc_fused_kernel (blc_layer.cuh): one block per work item — an 8x32
//   interior tile, a 2x64 or 64x2 band of the boundary ring, or a 2x2
//   corner, each with its weight class and window origin — so the ring
//   runs on the tensor cores in the same launch. The block stages its
//   input halo channels-last in shared memory, already split into TF32
//   hi/lo parts, applying the previous layer's GroupNorm and activation
//   on load;
//   runs m16n8k8 TF32 mma.sync three times per product (3xTF32, float32
//   accuracy); adds the bias; writes the raw field and per-block (sum,
//   sum of squares) in double. The last block of a field (a self-resetting
//   ticket counter) adds the partial sums in block order and writes each
//   group's (mean, rstd): no float atomics, the same bits every call.
// - gn_apply_kernel: after a stack's last GroupNorm layer, y = act(GN(y))
//   in place, and for the stem the four successive 2x2 pools (the pyramid
//   inputs) from the same tile.
// - The five branch stacks share each launch: layer r of every level is
//   one grid (level 0's items first), so the small levels (8x31 .. 64x253)
//   fill the SMs beside level 0 instead of running as latency-bound chains.
// Launches per stack call: R layer launches + 1 apply pass (GroupNorm) or
// R (merge 2: bias + act in the epilogue; merge 3: bias only), + 1 for the
// optional pool of the input. Staging is single-buffered: each SM holds 3
// blocks (60 KB of shared memory, <= 80 registers a thread), whose
// staging and MMA phases overlap one another.
#include "blc_layer.cuh"

namespace pmc {
namespace {

// VALID 2x2 average pool, (C, H, W) -> (C, H/2, W/2), odd sizes floor.
__global__ void __launch_bounds__(256)
avg_pool2_kernel(const float* __restrict__ x, float* __restrict__ out, int C,
                 int H, int W) {
  const int h = H / 2, w = W / 2;
  const size_t total = (size_t)C * h * w;
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    const int c = (int)(i / ((size_t)h * w));
    const int rem = (int)(i - (size_t)c * h * w);
    const int r = rem / w, col = rem - (rem / w) * w;
    const float* p = x + ((size_t)c * H + 2 * r) * W + 2 * col;
    out[i] = 0.25f * ((p[0] + p[1]) + (p[W] + p[W + 1]));
  }
}

int grid_for(size_t n, int threads) {
  const size_t b = (n + threads - 1) / threads;
  return (int)(b < 4096 ? (b > 0 ? b : 1) : 4096);
}

}  // namespace

// one layer's weight fragments: 9 classes (learned) or 1 (zero padding)
size_t frag_floats(int c_in, int c_o, bool zero) {
  return (size_t)(zero ? 1 : 9) * NTAP * ((c_in + 7) / 8) * ((c_o + 7) / 8) * 128;
}

}  // namespace pmc

extern "C" {

const char* pmc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Work items (blocks) of one field's layer launch: the size of its
// per-block GroupNorm scratch, in units of (c_o, 2) doubles. zero_pad:
// the zero-padded instance's, else the learned-boundary one's.
int pmc_work_items(int H, int W, int zero_pad) {
  return pmc::n_items(H, W, zero_pad != 0);
}

// L fields (pyramid levels) through stacks of equal shape. Per level l:
// input xs[l] (c_in, H_l, W_l), output ys[l] (c_o, H_l, W_l), scratch[l]
// (c_o, H_l, W_l; may be null when R == 1), weight fragments frags[l] (the
// R layers' blocks back to back, see ops/branch_kernel.py::pack_stack),
// bias / GN scale / GN shift (R, c_o). Workspace: stats (L, R, groups, 2)
// floats, partial L x partial_stride doubles, counters[L] ints that are 0
// (and are 0 again after the call). With n_pyr > 0 (L == 1), pyr[i]
// receives the (i+1)-th successive 2x2 pool of the output; with pool_out
// non-null (L == 1), the 2x2 pool of the input. zero_pad: the layers are
// zero-padded SAME convs with one weight class, else learned-boundary
// convs with nine. act: the activation code after each layer
// (blc_layer.cuh::Act; 0 applies none).
int pmc_layer_stacks(int L, const void* const* xs, void* const* ys,
                     void* const* scratch, const int* hw,
                     const void* const* frags, const void* const* bias,
                     const void* const* gsc, const void* const* gsh,
                     float* stats, double* partial, int partial_stride,
                     int* counters, void* const* pyr, int n_pyr,
                     float* pool_out, int c_in, int c_o, int R, int groups,
                     int use_gn, int act, int zero_pad,
                     void* stream_ptr) {
  using namespace pmc;
  const bool zero = zero_pad != 0;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (L < 1 || L > kMaxLevels || R < 1 || c_in < 1 || c_o < 1 ||
      c_o > kMaxCo || n_pyr < 0 || n_pyr > kMaxPyramid ||
      ((n_pyr > 0 || pool_out != nullptr) && L != 1) || !valid_act(act))
    return cudaErrorInvalidValue;
  if (use_gn && (groups < 1 || groups > c_o || c_o % groups))
    return cudaErrorInvalidValue;
  for (int l = 0; l < L; ++l) {
    const int min_hw = zero ? 1 : 6;   // the learned ring's 6-row slabs
    if (hw[2 * l] < min_hw || hw[2 * l + 1] < min_hw)
      return cudaErrorInvalidValue;
    if (R > 1 && scratch[l] == nullptr) return cudaErrorInvalidValue;
    if (partial_stride < n_items(hw[2 * l], hw[2 * l + 1], zero) * c_o * 2)
      return cudaErrorInvalidValue;
  }
  if (pool_out != nullptr) {
    const int H = hw[0], W = hw[1];
    const size_t n = (size_t)c_in * (H / 2) * (W / 2);
    avg_pool2_kernel<<<grid_for(n, 256), 256, 0, stream>>>(
        static_cast<const float*>(xs[0]), pool_out, c_in, H, W);
  }
  auto dst = [&](int l, int r) {
    return static_cast<float*>((R - 1 - r) % 2 == 0 ? ys[l] : scratch[l]);
  };
  auto stat = [&](int l, int r) {
    return stats + ((size_t)l * R + r) * groups * 2;
  };
  size_t w_off = 0;
  for (int r = 0; r < R; ++r) {
    const int ci = r == 0 ? c_in : c_o;
    LayerArgs a{};
    a.n_levels = L;
    a.c_in = ci;
    a.c_o = c_o;
    a.groups = use_gn ? groups : 1;
    a.gn_out = use_gn;
    a.act_out = act != kActNone;
    int start = 0;
    for (int l = 0; l < L; ++l) {
      LayerLevel& v = a.lv[l];
      v.x = r == 0 ? static_cast<const float*>(xs[l]) : dst(l, r - 1);
      v.y = dst(l, r);
      v.frag = static_cast<const float*>(frags[l]) + w_off;
      v.bias = static_cast<const float*>(bias[l]) + (size_t)r * c_o;
      if (r > 0 && use_gn) {
        v.in_stats = stat(l, r - 1);
        v.in_scale = static_cast<const float*>(gsc[l]) + (size_t)(r - 1) * c_o;
        v.in_shift = static_cast<const float*>(gsh[l]) + (size_t)(r - 1) * c_o;
      }
      v.stats_out = stat(l, r);
      v.partial = partial + (size_t)l * partial_stride;
      v.counter = counters + l;
      v.H = hw[2 * l];
      v.W = hw[2 * l + 1];
      v.start = start;
      start += n_items(v.H, v.W, zero);
    }
    const cudaError_t err =
        launch_layer<false>(a, TrunkSrc{}, zero, act, stream);
    if (err != cudaSuccess) return err;
    w_off += frag_floats(ci, c_o, zero);
  }
  if (use_gn || n_pyr > 0) {
    ApplyArgs a{};
    a.n_levels = L;
    a.c_o = c_o;
    a.groups = use_gn ? groups : 1;
    a.act = act != kActNone;
    int start = 0;
    for (int l = 0; l < L; ++l) {
      ApplyLevel& v = a.lv[l];
      v.y = static_cast<float*>(ys[l]);
      if (use_gn) {
        v.stats = stat(l, R - 1);
        v.scale = static_cast<const float*>(gsc[l]) + (size_t)(R - 1) * c_o;
        v.shift = static_cast<const float*>(gsh[l]) + (size_t)(R - 1) * c_o;
      }
      v.n_pyr = l == 0 ? n_pyr : 0;
      for (int i = 0; i < v.n_pyr; ++i) v.pyr[i] = static_cast<float*>(pyr[i]);
      v.H = hw[2 * l];
      v.W = hw[2 * l + 1];
      v.start = start;
      start += apply_blocks(v.H, v.W, c_o);
    }
    const cudaError_t err = launch_apply(a, act, stream);
    if (err != cudaSuccess) return err;
  }
  return cudaGetLastError();
}

}  // extern "C"
