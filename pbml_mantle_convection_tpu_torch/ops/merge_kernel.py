"""``trunk``: bicubic upsampling of the coarse branches + merge-1.

Replaces the TPU kernel ``pbml_mantle_convection_tpu/ops/merge_kernel.py::
_trunk_kernel`` (``TrunkStack``). It takes NewFluidNet's merge input —
branch 0, the coarse branches upsampled to H × W (Keys a = -0.75,
half-pixel, clamped indices), the network input — and runs the merge-1
conv (learned-boundary, or zero-padded when the merge layer's
``StackWeights.zero_pad`` says so), bias, GroupNorm and the merge layer's
activation (``StackWeights.act``, any of the seven). On a CUDA
tensor it launches ``csrc/trunk.cu``; on a CPU tensor it runs
:func:`trunk_plain` (the resize matrices, ``torch.cat`` and
:func:`layer_stack_plain`).

What was built for the card (the note at the top of ``csrc/trunk.cu``):
the layer kernel of ``csrc/blc_layer.cuh`` — 3xTF32 tensor-core conv, ring
and GroupNorm statistics in the same launch — with the 87-channel input
assembled chunk by chunk in its staging step, the coarse branches
upsampled there from the tap tables of :func:`trunk_weights`; no
concatenated buffer is written. Two launches per call.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Sequence

import numpy as np
import torch

from ..utils.profiling import span
from . import _cuda
from .branch_kernel import StackWeights, act_code, layer_stack_plain
from .resize import _resize_matrix_np, resize_bicubic_nchw


def _taps(in_size: int, out_size: int):
    """The ≤4 non-zero entries of each row of the resize matrix, in
    ascending index order, padded in front with zero weights at the index
    below the first (clamped at 0): (out_size, 4) int32 indices,
    (out_size, 4) weights. A row whose source point falls on a coarse
    pixel has one non-zero entry, and its next row starts one index lower;
    with the padding in front, the first index never decreases from one
    row to the next, and the layer kernel reads the coarse columns of a
    tile from the first index of its first column on (``stage_trunk`` in
    ``csrc/blc_layer.cuh``). The zero-weight products come first in each
    sum, so the sums are those of the non-zero entries, bit for bit."""
    M = _resize_matrix_np(in_size, out_size)
    idx = np.zeros((out_size, 4), np.int32)
    wts = np.zeros((out_size, 4), np.float64)
    for o in range(out_size):
        nz = np.nonzero(M[o])[0]
        k = 4 - len(nz)
        idx[o, :k] = max(nz[0] - 1, 0)
        idx[o, k:] = nz
        wts[o, k:] = M[o, nz]
    if np.any(np.diff(idx[:, 0]) < 0) or np.any(idx[:, :1] > idx):
        raise AssertionError(f"resize taps {in_size} → {out_size}: the "
                             f"first index decreases")
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

    @property
    def zero_pad(self) -> bool:
        """The zero-padded instance of merge-1, else learned-boundary."""
        return self.merge.zero_pad


def trunk_weights(merge: StackWeights, coarse_hw: Sequence, H: int, W: int
                  ) -> TrunkWeights:
    dev, dt = merge.bias.device, merge.bias.dtype
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
    with span("pmc.kernel.trunk"):
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
        m, n = tw.merge, len(coarse)
        if c_h % 8 or not (m.use_gn and m.use_act) or n > _cuda.MAX_LEVELS:
            raise ValueError("trunk: the kernel takes c_h a multiple of 8, "
                             "GroupNorm followed by an activation, "
                             f"≤ {_cuda.MAX_LEVELS} coarse branches")
        for t in (m.frag, m.bias, m.gn_scale, m.gn_bias, tw.y_w, tw.x_w):
            _cuda.check_cuda_f32("trunk weights", t)
            if t.device != b0.device:
                raise ValueError("trunk: weights and fields on different "
                                 "devices")
        lib = _cuda.library()
        ptrs = (ctypes.c_void_p * max(n, 1))(*[c.data_ptr() for c in coarse])
        hws = (ctypes.c_int * max(2 * n, 1))(*[v for hw in tw.coarse_hw
                                                for v in hw])
        y = torch.empty((c_h, H, W), device=b0.device)
        stats = torch.empty((m.groups * 2,), device=b0.device)
        partial = torch.empty((_cuda.work_items(H, W, m.zero_pad) * c_h * 2,),
                              dtype=torch.float64, device=b0.device)
        err = lib.pmc_trunk(
            b0.data_ptr(), ptrs, hws, n, x.data_ptr(), c_x, y.data_ptr(),
            stats.data_ptr(), partial.data_ptr(),
            _cuda.counters(b0.device).data_ptr(), tw.y_idx.data_ptr(),
            tw.y_w.data_ptr(), tw.x_idx.data_ptr(), tw.x_w.data_ptr(),
            m.frag.data_ptr(), m.bias.data_ptr(), m.gn_scale.data_ptr(),
            m.gn_bias.data_ptr(), c_h, H, W, m.groups, act_code(m.act),
            int(m.zero_pad), _cuda.stream(b0))
        trunk.launches += 1
        _cuda.raise_on_error(err, "trunk")
        return y


trunk.launches = 0
