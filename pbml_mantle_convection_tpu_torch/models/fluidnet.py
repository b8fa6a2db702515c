"""NewFluidNet: the multi-scale parallel-branch Stokes surrogate.

Counterpart of ``NewFluidNet`` in the JAX package's ``models/fluidnet.py``
(reference: pytorch_networks_convae.py:1068-1388). Public layout is the
JAX one: input (B, H, W, c_i) NHWC, outputs u, v of shape (B, H, W); the
layers run NCHW inside.

Inputs (7 channels): ``(xc/4, yc/4, log10(V)/8, raq_nd, fkt_nd, fkp_nd,
T)`` (datasetio.py:630-641).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn

from ..ops.curl import curl_head_padded
from ..ops.resize import avg_pool_nchw, resize_bicubic_nchw
from .layers import (BoundaryLearnedConvolution2D, Conv2dTorch, FluidLayer,
                     GroupNormTorch, blc_slab, get_activation)


class NewFluidNet(nn.Module):
    """stem FluidLayer → ``levels`` parallel branches (branch *l*
    avg-pools *l* times by ``factor``, runs ``repeats`` FluidLayers,
    bicubic-upsamples back) → concat of all branches + the input →
    merge conv + GN + act → conv + act → out conv → subtract the spatial
    mean → head ("mae"/"mass": raw channels; "curl": stream function
    through the curl head).

    Weights are drawn from ``np.random.default_rng(seed)`` and the model
    is moved to ``device`` (default: the card).
    """

    def __init__(self, levels: int, c_i: int, c_h: int, c_o: int,
                 act_fn: str = "selu", r_p: str = "zeros",
                 loss_type: str = "mae", a_bound: float = 4.0,
                 repeats: int = 3, f: int = 3, p_pred: bool = True,
                 factor: int = 2, seed: int = 0, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.levels, self.c_i, self.c_h, self.c_o = levels, c_i, c_h, c_o
        self.act_fn, self.r_p, self.loss_type = act_fn, r_p, loss_type
        self.a_bound, self.repeats, self.f = a_bound, repeats, f
        self.p_pred, self.factor = p_pred, factor
        learned = r_p == "learned"
        rng = np.random.default_rng(seed)

        self.conv_0 = FluidLayer(c_i, c_h, rng, act_fn, r_p, f)
        for l in range(levels):
            for r in range(repeats):
                self.add_module(f"convs_{l}_{r}",
                                FluidLayer(c_h, c_h, rng, act_fn, r_p, f))
        c_cat = c_h * levels + c_i

        def merge(c_in, c_out):
            if learned:
                return BoundaryLearnedConvolution2D(c_in, c_out, f, rng)
            return Conv2dTorch(c_in, c_out, 3, rng, pad_mode=r_p,
                               explicit_padding=(1, 1))

        self.conv_1 = merge(c_cat, c_h)
        self.gn_0 = GroupNormTorch(max(1, c_h // 4), c_h)
        self.conv_2 = merge(c_h, c_h)
        self.conv_3 = merge(c_h, c_o)
        self.act = get_activation(act_fn)
        self.to(device=device or "cuda", dtype=dtype)

    def check_size(self, H: int, W: int) -> None:
        """Eager config check: the learned-padding stitch slices edge
        slabs of width k+1 (k == 5); a branch pooled below that would
        collapse to an empty VALID conv deep in the forward pass."""
        if self.r_p != "learned":
            return
        slab = blc_slab(self.f)
        hd = H // self.factor ** (self.levels - 1)
        wd = W // self.factor ** (self.levels - 1)
        if min(hd, wd) < slab:
            raise ValueError(
                f"NewFluidNet: levels={self.levels} pools the deepest "
                f"branch of a {H}x{W} grid to {hd}x{wd}, below the "
                f"{slab}x{slab} minimum of the learned-padding k={self.f} "
                f"layers — reduce levels or enlarge the grid")

    def head(self, y):
        """(B, c_o, H, W) merge-3 output → (u, v, p|None) of (B, H, W)."""
        y = y - y.mean(dim=(2, 3), keepdim=True)
        if self.loss_type in ("mae", "mass"):
            return y[:, 0], y[:, 1], (y[:, 2] if self.p_pred else None)
        u, v = curl_head_padded(y[:, 0] * self.a_bound)
        return u, v, (y[:, 1] if self.p_pred else None)

    def forward(self, inputs):
        B, H, W, _ = inputs.shape
        self.check_size(H, W)
        x = inputs.permute(0, 3, 1, 2)
        x_in = self.conv_0(x)
        branches = []
        for l in range(self.levels):
            y1 = x_in
            for _ in range(l):
                y1 = avg_pool_nchw(y1, self.factor)
            for r in range(self.repeats):
                y1 = getattr(self, f"convs_{l}_{r}")(y1)
            if l > 0:
                y1 = resize_bicubic_nchw(y1, (H, W))
            branches.append(y1)
        y = torch.cat(branches + [x], dim=1)
        y = self.act(self.gn_0(self.conv_1(y)))
        y = self.act(self.conv_2(y))
        return self.head(self.conv_3(y))
