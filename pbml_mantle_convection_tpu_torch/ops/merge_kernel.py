"""``trunk``: bicubic upsampling of the coarse branches + merge-1.

Replaces the TPU kernel ``pbml_mantle_convection_tpu/ops/merge_kernel.py::
_trunk_kernel`` (``TrunkStack``). It builds NewFluidNet's merge input —
branch 0, the coarse branches upsampled to H × W (Keys a = -0.75,
half-pixel, clamped indices), the network input — and runs the merge-1
learned-boundary conv, bias, GroupNorm and GELU. On a CUDA tensor it
launches ``csrc/trunk.cu``; on a CPU tensor it runs :func:`trunk_plain`
(the resize matrices, ``torch.cat`` and :func:`layer_stack_plain`).

What bounds it on the card (operations: the 87→16 conv) and what the
design does about it is written at the top of ``csrc/trunk.cu``.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Sequence

import numpy as np
import torch

from . import _cuda
from .branch_kernel import StackWeights, layer_stack_plain
from .resize import _resize_matrix_np, resize_bicubic_nchw


def _taps(in_size: int, out_size: int):
    """The ≤4 non-zero entries of each row of the resize matrix, padded
    with zero weights: (out_size, 4) int32 indices, (out_size, 4) weights."""
    M = _resize_matrix_np(in_size, out_size)
    idx = np.zeros((out_size, 4), np.int32)
    wts = np.zeros((out_size, 4), np.float64)
    for o in range(out_size):
        nz = np.nonzero(M[o])[0]
        idx[o, :len(nz)] = nz
        wts[o, :len(nz)] = M[o, nz]
    return idx, wts


@dataclasses.dataclass(frozen=True)
class TrunkWeights:
    """The merge-1 layer and the upsampling tables of one (H, W) grid."""

    merge: StackWeights
    coarse_hw: tuple          # ((h_l, w_l), ...) of branches 1..L-1
    H: int
    W: int
    y_idx: torch.Tensor       # (L-1, H, 4) int32
    y_w: torch.Tensor         # (L-1, H, 4)
    x_idx: torch.Tensor       # (L-1, W, 4) int32
    x_w: torch.Tensor         # (L-1, W, 4)


def trunk_weights(merge: StackWeights, coarse_hw: Sequence, H: int, W: int
                  ) -> TrunkWeights:
    dev, dt = merge.packed.device, merge.packed.dtype
    ys = [_taps(h, H) for h, _ in coarse_hw]
    xs = [_taps(w, W) for _, w in coarse_hw]

    def stack(tabs, k, dtype):
        a = np.stack([t[k] for t in tabs]) if tabs else np.zeros((0, 1, 4))
        return torch.as_tensor(a, dtype=dtype, device=dev).contiguous()

    return TrunkWeights(merge, tuple(tuple(hw) for hw in coarse_hw), H, W,
                        stack(ys, 0, torch.int32), stack(ys, 1, dt),
                        stack(xs, 0, torch.int32), stack(xs, 1, dt))


def trunk_plain(b0, coarse: Sequence[torch.Tensor], x, tw: TrunkWeights):
    """Plain PyTorch version of :func:`trunk`."""
    up = [resize_bicubic_nchw(c, (tw.H, tw.W)) for c in coarse]
    y, _ = layer_stack_plain(torch.cat([b0, *up, x], dim=0), tw.merge)
    return y


def trunk(b0: torch.Tensor, coarse: Sequence[torch.Tensor], x: torch.Tensor,
          tw: TrunkWeights) -> torch.Tensor:
    """b0 (c_h, H, W), coarse branches (c_h, h_l, w_l), input x
    (c_x, H, W) → merge-1 output (c_h, H, W)."""
    if b0.device.type == "cpu":
        return trunk_plain(b0, coarse, x, tw)
    c_h, H, W = tw.merge.c_o, tw.H, tw.W
    if len(coarse) != len(tw.coarse_hw):
        raise ValueError(f"trunk: expected {len(tw.coarse_hw)} coarse "
                         f"branches, got {len(coarse)}")
    _cuda.check_cuda_f32("trunk b0", b0, (c_h, H, W))
    for c, (h, w) in zip(coarse, tw.coarse_hw):
        _cuda.check_cuda_f32("trunk coarse branch", c, (c_h, h, w))
    c_x = tw.merge.c_in - c_h * (len(coarse) + 1)
    _cuda.check_cuda_f32("trunk x", x, (c_x, H, W))
    for t in (tw.merge.packed, tw.merge.bias, tw.merge.gn_scale,
              tw.merge.gn_bias, tw.y_w, tw.x_w):
        _cuda.check_cuda_f32("trunk weights", t)
        if t.device != b0.device:
            raise ValueError("trunk: weights and fields on different devices")
    lib = _cuda.library()
    n = len(coarse)
    ptrs = (ctypes.c_void_p * max(n, 1))(*[c.data_ptr() for c in coarse])
    hws = (ctypes.c_int * max(2 * n, 1))(*[v for hw in tw.coarse_hw
                                            for v in hw])
    cat = torch.empty((tw.merge.c_in, H, W), device=b0.device)
    y = torch.empty((c_h, H, W), device=b0.device)
    stats = torch.empty((_cuda.gn_stats_len(tw.merge.groups),),
                        dtype=torch.float64, device=b0.device)
    m = tw.merge
    err = lib.pmc_trunk(
        b0.data_ptr(), ptrs, hws, n, x.data_ptr(), c_x, cat.data_ptr(),
        y.data_ptr(), stats.data_ptr(), tw.y_idx.data_ptr(),
        tw.y_w.data_ptr(), tw.x_idx.data_ptr(), tw.x_w.data_ptr(),
        m.packed.data_ptr(), m.bias.data_ptr(), m.gn_scale.data_ptr(),
        m.gn_bias.data_ptr(), c_h, H, W, m.groups, _cuda.stream(b0))
    trunk.launches += 1
    _cuda.raise_on_error(err, "trunk")
    return y


trunk.launches = 0
