"""The FluidNet family of Stokes surrogates (multi-scale parallel-branch
CNNs).

Counterparts of ``NewFluidNet``, ``FluidNet``, ``HalfNewFluidNet`` and
``MultiScaleNewFluidNet`` in the JAX package's ``models/fluidnet.py``
(reference: pytorch_networks_convae.py:1068-1697; the last two are the JAX
package's reconstructions of classes the reference lost, SURVEY.md §2).
Public layout is the JAX one: input (B, H, W, c_i) NHWC, outputs u, v of
shape (B, H, W); the layers run NCHW inside.

Inputs (7 channels): ``(xc/4, yc/4, log10(V)/8, raq_nd, fkt_nd, fkp_nd,
T)`` (datasetio.py:630-641).

Options, as in JAX: ``use_symm`` (symmetric convs in every FluidLayer
and learned merge), ``spectral_conv`` (every FluidLayer a
SpectralFluidLayer), ``dilation`` (the FluidLayers and the *plain*
merge-1 only), ``drop_rate`` (dropout after each FluidLayer's
activation when ``forward`` is given a generator) and ``blurr`` (a 3×3
box blur of the stream function before the curl head).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

from ..ops.curl import blur3x3, curl_head_cropped, curl_head_padded
from ..ops.resize import avg_pool_nchw, resize_bicubic_nchw
from .layers import (BoundaryLearnedConvolution2D, Conv2dTorch,
                     GroupNormTorch, blc_slab, fluid_layer, get_activation)


def _head(m, y, curl_head=curl_head_padded):
    """(B, c_o, H', W') mean-subtracted output → (u, v, p|None) for
    ``m``'s loss type: raw channels under "mae"/"mass", else the stream
    function (× a_bound, blurred with ``blurr``) through ``curl_head``."""
    if m.loss_type in ("mae", "mass"):
        return y[:, 0], y[:, 1], (y[:, 2] if m.p_pred else None)
    a = y[:, 0] * m.a_bound
    if m.blurr:
        a = blur3x3(a)
    u, v = curl_head(a)
    return u, v, (y[:, 1] if m.p_pred else None)


def plain_curl_head(m) -> bool:
    """Whether ``m``'s head is the curl of its one output channel with
    nothing more (no ``blurr``, no ``p_pred``, not the ``mae``/``mass``
    heads): the head the fused curl + advection epilogue computes."""
    return (m.loss_type not in ("mae", "mass") and not m.blurr
            and not m.p_pred)


class _Branches(nn.Module):
    """The trunk that the family shares: stem FluidLayer ``conv_0`` →
    ``levels`` parallel branches (branch *l* avg-pools *l* times by
    ``factor``, runs ``repeats`` FluidLayers ``convs_{l}_{r}``,
    bicubic-upsamples back) → concat of all branches + the input. The
    subclass adds its merges (``conv_1``, ``gn_0``, ...), drawn from the
    same ``rng``, and its head, and moves the model to its device."""

    def __init__(self, levels: int, c_i: int, c_h: int, c_o: int,
                 act_fn: str, r_p: str, loss_type: str, use_symm: bool,
                 dilation: int, a_bound: float, repeats: int, f: int,
                 p_pred: bool, spectral_conv: bool, blurr: bool,
                 drop_rate: float, factor: int, rng: np.random.Generator):
        super().__init__()
        self.levels, self.c_i, self.c_h, self.c_o = levels, c_i, c_h, c_o
        self.act_fn, self.r_p, self.loss_type = act_fn, r_p, loss_type
        self.use_symm, self.dilation = use_symm, dilation
        self.a_bound, self.repeats, self.f = a_bound, repeats, f
        self.p_pred, self.spectral_conv, self.blurr = (p_pred, spectral_conv,
                                                       blurr)
        self.drop_rate, self.factor = drop_rate, factor
        self.learned = r_p == "learned"

        def layer(c_in):
            return fluid_layer(c_in, c_h, rng, act_fn, r_p, f,
                               use_symm, dilation, drop_rate, spectral_conv)

        self.conv_0 = layer(c_i)
        for l in range(levels):
            for r in range(repeats):
                self.add_module(f"convs_{l}_{r}", layer(c_h))
        self.act = get_activation(act_fn)

    def merge(self, rng, c_in: int, c_out: int, bc: int = 1, pad: int = 1,
              dilation: int = 1, merge_1: bool = False) -> nn.Module:
        """A merge conv: learned-boundary (with ``bc``, symmetric with
        ``use_symm``) under learned padding, else a plain 3×3 conv padded
        by ``pad`` with the padding mode and ``dilation``. A learned
        ``merge_1`` takes its slabs' weight gradients off cuDNN: at the
        production grid cuDNN's float32 ones of those wide boundary slabs
        are ~1e-4 off, a direct sum ~1e-6 (ROADMAP §3 faults 7 and 9,
        tools/torch_port_grad_precision.py)."""
        if self.learned:
            conv = BoundaryLearnedConvolution2D(c_in, c_out, self.f, rng,
                                                bc, bc, self.use_symm)
            conv.wgrad_off_cudnn = merge_1
            return conv
        return Conv2dTorch(c_in, c_out, 3, rng, pad_mode=self.r_p,
                           explicit_padding=(pad, pad), dilation=dilation)

    def check_size(self, H: int, W: int) -> None:
        """Eager config check: the learned-padding stitch slices edge
        slabs of width k+1 (k == 5); a branch pooled below that would
        collapse to an empty VALID conv deep in the forward pass."""
        if not self.learned:
            return
        slab = blc_slab(self.f)
        hd = H // self.factor ** (self.levels - 1)
        wd = W // self.factor ** (self.levels - 1)
        if min(hd, wd) < slab:
            raise ValueError(
                f"{type(self).__name__}: levels={self.levels} pools the "
                f"deepest branch of a {H}x{W} grid to {hd}x{wd}, below the "
                f"{slab}x{slab} minimum of the learned-padding k={self.f} "
                f"layers — reduce levels or enlarge the grid")

    def branches(self, x, generator=None):
        """(B, c_i, H, W) → (B, c_h·levels + c_i, H, W)."""
        H, W = x.shape[-2:]
        x_in = self.conv_0(x, generator)
        outs = []
        for l in range(self.levels):
            y1 = x_in
            for _ in range(l):
                y1 = avg_pool_nchw(y1, self.factor)
            for r in range(self.repeats):
                y1 = getattr(self, f"convs_{l}_{r}")(y1, generator)
            if l > 0:
                y1 = resize_bicubic_nchw(y1, (H, W))
            outs.append(y1)
        return torch.cat(outs + [x], dim=1)


class NewFluidNet(_Branches):
    """stem FluidLayer → ``levels`` parallel branches → concat of all
    branches + the input → merge conv + GN + act → conv + act → out conv
    → subtract the spatial mean → head ("mae"/"mass": raw channels;
    "curl": stream function through the padded curl head).

    Weights are drawn from ``np.random.default_rng(seed)`` and the model
    is moved to ``device`` (default: the card).
    """

    def __init__(self, levels: int, c_i: int, c_h: int, c_o: int,
                 act_fn: str = "selu", r_p: str = "zeros",
                 loss_type: str = "mae", use_symm: bool = False,
                 dilation: int = 1, a_bound: float = 4.0,
                 repeats: int = 3, f: int = 3, p_pred: bool = True,
                 spectral_conv: bool = False, blurr: bool = False,
                 drop_rate: float = 0.0, factor: int = 2, seed=0,
                 device=None, dtype=torch.float32):
        rng = np.random.default_rng(seed)
        super().__init__(levels, c_i, c_h, c_o, act_fn, r_p, loss_type,
                         use_symm, dilation, a_bound, repeats, f, p_pred,
                         spectral_conv, blurr, drop_rate, factor, rng)
        c_cat = c_h * levels + c_i
        # dilation reaches the plain merge-1 and not merges 2 and 3, as in
        # JAX (fluidnet.py:123-148)
        self.conv_1 = self.merge(rng, c_cat, c_h, dilation=dilation,
                                 merge_1=True)
        self.gn_0 = GroupNormTorch(max(1, c_h // 4), c_h)
        self.conv_2 = self.merge(rng, c_h, c_h)
        self.conv_3 = self.merge(rng, c_h, c_o)
        self.to(device=device or "cuda", dtype=dtype)

    def head(self, y):
        """(B, c_o, H, W) merge-3 output → (u, v, p|None) of (B, H, W)."""
        return _head(self, y - y.mean(dim=(2, 3), keepdim=True))

    def forward(self, inputs, generator: Optional[torch.Generator] = None):
        _, H, W, _ = inputs.shape
        self.check_size(H, W)
        y = self.branches(inputs.permute(0, 3, 1, 2), generator)
        y = self.act(self.gn_0(self.conv_1(y)))
        y = self.act(self.conv_2(y))
        return self.head(self.conv_3(y))


class FluidNet(_Branches):
    """The older FluidNet: :class:`NewFluidNet`'s topology, except that
    under ``loss_type="curl"`` merge-1 grows the field to (H+2, W+2)
    (bc_x = bc_y = 2 for a learned conv, padding (2, 2) for a plain one),
    the mean is taken over that field, and the curl head crops back to
    (H, W) with no BC stamping (reference:
    pytorch_networks_convae.py:1392-1697). Learned padding gets
    NewFluidNet's eager size check (JAX's FluidNet fails there with an
    IndexError deep in its forward)."""

    def __init__(self, levels: int, c_i: int, c_h: int, c_o: int,
                 act_fn: str = "selu", r_p: str = "zeros",
                 loss_type: str = "mae", use_symm: bool = False,
                 dilation: int = 1, a_bound: float = 4.0,
                 repeats: int = 3, f: int = 3, p_pred: bool = True,
                 spectral_conv: bool = False, blurr: bool = False,
                 drop_rate: float = 0.0, factor: int = 2, seed=0,
                 device=None, dtype=torch.float32):
        rng = np.random.default_rng(seed)
        super().__init__(levels, c_i, c_h, c_o, act_fn, r_p, loss_type,
                         use_symm, dilation, a_bound, repeats, f, p_pred,
                         spectral_conv, blurr, drop_rate, factor, rng)
        c_cat = c_h * levels + c_i
        grow = loss_type == "curl"
        self.conv_1 = self.merge(rng, c_cat, c_h, bc=2 if grow else 1,
                                 pad=2 if grow else 1, dilation=dilation,
                                 merge_1=True)
        self.gn_0 = GroupNormTorch(max(1, c_h // 4), c_h)
        self.conv_2 = self.merge(rng, c_h, c_h)
        self.conv_3 = self.merge(rng, c_h, c_o)
        self.to(device=device or "cuda", dtype=dtype)

    def forward(self, inputs, generator: Optional[torch.Generator] = None):
        _, H, W, _ = inputs.shape
        self.check_size(H, W)
        y = self.branches(inputs.permute(0, 3, 1, 2), generator)
        y = self.act(self.gn_0(self.conv_1(y)))
        y = self.act(self.conv_2(y))
        y = self.conv_3(y)
        return _head(self, y - y.mean(dim=(2, 3), keepdim=True),
                     curl_head_cropped)


# why a HalfNewFluidNet neither trains nor rolls out on its own, in the
# port as in JAX
HALF_HEAD = ("halfnewfluidnet returns its raw (B, H, W, c_o) head, no "
             "(u, v, p): it is the multi-scale ensemble's member, and JAX's "
             "train step and stepper fail unpacking it too (a ValueError, "
             "or at B = 3 a TypeError)")


class HalfNewFluidNet(_Branches):
    """:class:`NewFluidNet` without merge 2: stem, branches, merge-1 + GN
    + act, the out conv, minus the spatial mean; returns that raw
    (B, H, W, c_o) head (NHWC). The per-scale member of
    :class:`MultiScaleNewFluidNet` (a reconstruction of a class the
    reference lost; its options that only act in a head, ``loss_type``,
    ``a_bound``, ``p_pred`` and ``blurr``, are kept and unused, as in
    JAX)."""

    def __init__(self, levels: int, c_i: int, c_h: int, c_o: int,
                 act_fn: str = "selu", r_p: str = "zeros",
                 loss_type: str = "mae", use_symm: bool = False,
                 dilation: int = 1, a_bound: float = 4.0,
                 repeats: int = 3, f: int = 3, p_pred: bool = True,
                 spectral_conv: bool = False, blurr: bool = False,
                 drop_rate: float = 0.0, factor: int = 2, seed=0,
                 device=None, dtype=torch.float32):
        rng = np.random.default_rng(seed)
        super().__init__(levels, c_i, c_h, c_o, act_fn, r_p, loss_type,
                         use_symm, dilation, a_bound, repeats, f, p_pred,
                         spectral_conv, blurr, drop_rate, factor, rng)
        c_cat = c_h * levels + c_i
        self.conv_1 = self.merge(rng, c_cat, c_h, merge_1=True)
        self.gn_0 = GroupNormTorch(max(1, c_h // 4), c_h)
        self.conv_3 = self.merge(rng, c_h, c_o)
        self.to(device=device or "cuda", dtype=dtype)

    def raw(self, x, generator=None):
        """(B, c_i, H, W) → the mean-subtracted (B, c_o, H, W) head."""
        y = self.branches(x, generator)
        y = self.conv_3(self.act(self.gn_0(self.conv_1(y))))
        return y - y.mean(dim=(2, 3), keepdim=True)

    def forward(self, inputs, generator: Optional[torch.Generator] = None):
        return self.raw(inputs.permute(0, 3, 1, 2),
                        generator).permute(0, 2, 3, 1)


class MultiScaleNewFluidNet(nn.Module):
    """Ensemble of :class:`HalfNewFluidNet` members ``nets_{i}`` over
    viscosity scales (the JAX package's reconstruction of the lost
    reference class, multigpu.py:562). Member *i* sees the input with its
    viscosity channel (index 2, log10(V)/8) re-centred on log10(scale_i);
    the members' raw heads are blended by a softmax gate over
    −|log10(V) − log10(scale_i)|, and the blend, minus its spatial mean,
    goes through the standard head (padded curl head under "curl").
    Member *i*'s weights come from ``np.random.default_rng((seed, i))``.
    """

    def __init__(self, levels: int, c_i: int, c_h: int, c_o: int,
                 scales: Sequence[float] = (1e-5, 1e-3, 1e-1, 1e1),
                 act_fn: str = "selu", r_p: str = "zeros",
                 loss_type: str = "curl", use_symm: bool = False,
                 dilation: int = 1, a_bound: float = 4.0,
                 repeats: int = 3, f: int = 3, p_pred: bool = False,
                 spectral_conv: bool = False, blurr: bool = False,
                 drop_rate: float = 0.0, factor: int = 2, seed=0,
                 device=None, dtype=torch.float32):
        super().__init__()
        self.scales = tuple(scales)
        self.loss_type, self.a_bound = loss_type, a_bound
        self.p_pred, self.blurr = p_pred, blurr
        for i in range(len(self.scales)):
            self.add_module(f"nets_{i}", HalfNewFluidNet(
                levels, c_i, c_h, c_o, act_fn=act_fn, r_p=r_p,
                loss_type=loss_type, use_symm=use_symm, dilation=dilation,
                a_bound=a_bound, repeats=repeats, f=f, p_pred=p_pred,
                spectral_conv=spectral_conv, blurr=blurr,
                drop_rate=drop_rate, factor=factor, seed=(seed, i),
                device=device, dtype=dtype))

    def forward(self, inputs, generator: Optional[torch.Generator] = None):
        log_v = inputs[..., 2] * 8.0        # undo the /8 featurization
        x = inputs.permute(0, 3, 1, 2)
        heads, gates = [], []
        for i, s in enumerate(self.scales):
            log_s = torch.log10(torch.tensor(s, dtype=inputs.dtype,
                                             device=inputs.device))
            d = log_v - log_s
            x_i = torch.cat([x[:, :2], (d / 8.0)[:, None], x[:, 3:]], dim=1)
            heads.append(getattr(self, f"nets_{i}").raw(x_i, generator))
            gates.append(-d.abs())
        gate = torch.softmax(torch.stack(gates, dim=1), dim=1)  # (B, S, H, W)
        y = sum(h * gate[:, i:i + 1] for i, h in enumerate(heads))
        y = y - y.mean(dim=(2, 3), keepdim=True)
        return _head(self, y)
