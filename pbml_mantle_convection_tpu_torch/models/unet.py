"""U-Net coupled (u, v, p, T) surrogate and the convolutional autoencoder.

Counterparts of ``Unet`` and ``ConvAE`` in the JAX package's
``models/unet.py``, with its structure and its parameter names (so a Flax
tree loads through ``utils/flax_convert.py``). Public layout is the JAX
one, NHWC in and out; the layers run NCHW inside. Weights are drawn from
``np.random.default_rng(seed)`` and the model is moved to ``device``
(default: the card).

``Unet`` (reference ``Unet``, pytorch_networks_convae.py:1700-2070): an
encoder–decoder with channel doubling per level, bicubic upsampling, the
input pre-padded by (3, 3) in x and the output cropped ``[..., 3:-3]``,
predicting the stream function *and* the temperature, so one network
advances the whole coupled step. Input: 11 channels (10 without p)
``(xc/4, yc/4, dt, raq_nd, fkt_nd, fkp_nd, log10(V)/8, T, u_prev,
v_prev[, p_prev])`` (datasetio.py:258-274); output ``(u, v, p|None, T)``.

``ConvAE`` (pycold-checkpoint.py:989-1114): stem FluidLayer, ``levels`` ×
(AvgPool(4) + ``repeats`` FluidLayers quadrupling the channels), a mid
stack, the mirrored bicubic decoder (to the recorded encoder sizes), an
output conv, and under ``curl`` a VALID curl head whose u, v are
concatenated with the interior of the other channels.

Both take the layer options as JAX's do: ``spectral_conv`` (every
FluidLayer a SpectralFluidLayer), ``use_symm`` (symmetric convs in the
FluidLayers and the learned merges), ``dilation`` (the FluidLayers and
the U-Net's plain ``conv_m3``) and, for the U-Net, ``drop_rate``
(dropout after each FluidLayer when ``forward`` is given a generator).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.curl import curl_head_padded, gaussian_blur_5x9
from ..ops.resize import avg_pool_nchw, resize_bicubic_nchw
from ..ops.stencils import dx_center, dy_center
from .layers import (_PAD_MODES, BoundaryLearnedConvolution2D, Conv2dTorch,
                     GroupNormTorch, fluid_layer, get_activation)


class Unet(nn.Module):
    """See the module doc. ``levels`` must be ≥ 2 (the reference decoder
    assumes it, pytorch_networks_convae.py:2006-2014)."""

    def __init__(self, levels: int, c_i: int, c_h: int, c_o: int,
                 act_fn: str = "gelu", r_p: str = "replicate",
                 loss_type: str = "curl", use_symm: bool = False,
                 dilation: int = 1, a_bound: float = 10.0,
                 repeats: int = 2, f: int = 5, p_pred: bool = False,
                 spectral_conv: bool = False, blurr: bool = False,
                 drop_rate: float = 0.0, seed: int = 0, device=None,
                 dtype=torch.float32):
        super().__init__()
        if levels < 2:
            raise ValueError("Unet requires levels >= 2")
        self.levels, self.c_i, self.c_h, self.c_o = levels, c_i, c_h, c_o
        self.r_p, self.loss_type, self.a_bound = r_p, loss_type, a_bound
        self.repeats, self.f, self.p_pred, self.blurr = (repeats, f, p_pred,
                                                         blurr)
        self.learned = r_p == "learned"
        self.pad_mode = _PAD_MODES[r_p] if not self.learned else None
        rng = np.random.default_rng(seed)

        def layer(c_in, c_out, bc_x=1):
            return fluid_layer(c_in, c_out, rng, act_fn, r_p, f, use_symm,
                               dilation, drop_rate, spectral_conv,
                               bc_x=bc_x)

        # level 0; with learned padding the first layer grows W by 6
        # (bc_x = 4, pytorch_networks_convae.py:1994-1995)
        ci = c_i
        for r in range(repeats):
            self.add_module(f"conv_{r}", layer(
                ci, c_h, 4 if (self.learned and r == 0) else 1))
            ci = c_h
        feat_ch = [c_h]
        ch = c_h
        for l in range(1, levels):
            for r in range(repeats):
                self.add_module(f"convs_{l - 1}_{r}", layer(ci, ch))
                ci = ch
            feat_ch.append(ch)
            ch *= 2
        ch //= 2
        # decoder (pytorch_networks_convae.py:2008-2012)
        for i, l in enumerate(range(levels - 2, 0, -1)):
            ci = feat_ch[l] + ci
            for r in range(repeats):
                self.add_module(f"upconvs_{i}_{r}", layer(ci, ch // 2))
                ci = ch // 2
            ch //= 2
        ci += feat_ch[0]

        def conv(c_in, c_out, dilation=1):
            if self.learned:
                return BoundaryLearnedConvolution2D(c_in, c_out, f, rng,
                                                    use_symm=use_symm)
            return Conv2dTorch(c_in, c_out, f, rng, padding="SAME",
                               pad_mode=r_p, dilation=dilation)

        # dilation reaches the plain conv_m3, not conv_m2 and conv_m1, as
        # in JAX (unet.py:112-139)
        self.conv_m3 = conv(ci, c_h, dilation)
        self.gn_0 = GroupNormTorch(max(1, c_h // 4), c_h)
        self.conv_m2 = conv(c_h, c_h)
        self.conv_m1 = conv(c_h, c_o)
        self.act = get_activation(act_fn)
        # cuDNN's float32 weight gradients of the pooled levels' convs and
        # of the 2·c_h-channel merge are ~1e-3 off at the production grid
        # (ROADMAP §3 fault 8, tools/torch_port_grad_precision.py --net
        # unet): they take theirs off cuDNN (a learned-boundary conv its
        # 8 slab convs')
        for name, mod in self.named_children():
            if name.startswith(("convs_", "upconvs_")):
                mod.conv.wgrad_off_cudnn = True
        self.conv_m3.wgrad_off_cudnn = True
        self.to(device=device or "cuda", dtype=dtype)

    def forward(self, inputs, generator: Optional[torch.Generator] = None):
        x = inputs.permute(0, 3, 1, 2)
        if not self.learned:
            # pad (3, 3, 0, 0) in x (pytorch_networks_convae.py:1990-1991)
            x = F.pad(x, (3, 3, 0, 0), mode=self.pad_mode)
        for r in range(self.repeats):
            x = getattr(self, f"conv_{r}")(x, generator)
        feats = [x]
        sizes = [tuple(x.shape[-2:])]
        for l in range(1, self.levels):
            x = avg_pool_nchw(x, 2)
            sizes.append(tuple(x.shape[-2:]))
            for r in range(self.repeats):
                x = getattr(self, f"convs_{l - 1}_{r}")(x, generator)
            feats.append(x)
        xu = feats[-1]
        for i, l in enumerate(range(self.levels - 2, 0, -1)):
            xu = torch.cat((feats[l], resize_bicubic_nchw(xu, sizes[l])),
                           dim=1)
            for r in range(self.repeats):
                xu = getattr(self, f"upconvs_{i}_{r}")(xu, generator)
        y = torch.cat((resize_bicubic_nchw(xu, sizes[0]), feats[0]), dim=1)
        y = self.act(self.gn_0(self.conv_m3(y)))
        y = self.act(self.conv_m2(y))
        y = self.conv_m1(y)
        # mean-subtract on the padded field, then crop the 3-col pads
        # (pytorch_networks_convae.py:2024)
        y = (y - y.mean(dim=(2, 3), keepdim=True))[..., 3:-3]
        if self.loss_type in ("mae", "mass"):
            return (y[:, 0], y[:, 1], y[:, 3] if self.p_pred else None,
                    y[:, 2])
        # curl head (pytorch_networks_convae.py:2038-2068)
        a = y[:, 0] * self.a_bound
        if self.blurr:
            a = gaussian_blur_5x9(a)
        T = torch.clamp(y[:, 1], 0.0, 1.5)
        p = y[:, 2] if self.p_pred else None
        u, v = curl_head_padded(a)
        return u, v, p, T


class ConvAE(nn.Module):
    """See the module doc. The decoder upsamples to the recorded encoder
    sizes (the reference's ``Upsample(scale_factor=4)`` cannot reproduce
    widths that 4 does not divide; on widths it divides the two are the
    same function)."""

    def __init__(self, levels: int, c_i: int, c_h: int, c_o: int,
                 act_fn: str = "selu", r_p: str = "zeros",
                 loss_type: str = "mae", use_symm: bool = False,
                 dilation: int = 1, a_bound: float = 4.0, repeats: int = 3,
                 f: int = 3, p_pred: bool = True,
                 spectral_conv: bool = False, blurr: bool = False,
                 seed: int = 0, device=None, dtype=torch.float32):
        super().__init__()
        self.levels, self.c_i, self.c_h, self.c_o = levels, c_i, c_h, c_o
        self.loss_type, self.a_bound = loss_type, a_bound
        self.repeats, self.p_pred = repeats, p_pred
        self.factor = 4
        rng = np.random.default_rng(seed)

        def layer(c_in, c_out):
            return fluid_layer(c_in, c_out, rng, act_fn, r_p, f, use_symm,
                               dilation, spectral=spectral_conv)

        self.stem = layer(c_i, c_h)
        ci = ch = c_h
        for l in range(levels):
            for r in range(repeats):
                self.add_module(f"enc_{l}_{r}", layer(ci, ch * 4))
                ci = ch * 4
            ch *= 4
        ch //= 4
        for r in range(repeats):
            self.add_module(f"mid_{r}", layer(ci, ch))
            ci = ch
        for i in range(levels):
            for r in range(repeats):
                self.add_module(f"dec_{i}_{r}", layer(ci, ch // 4))
                ci = ch // 4
            ch //= 4
        pad = 2 if loss_type == "curl" else 1
        self.out_conv = Conv2dTorch(ci, c_o, 3, rng, pad_mode=r_p,
                                    explicit_padding=(pad, pad))
        self.to(device=device or "cuda", dtype=dtype)

    def forward(self, inputs):
        x = self.stem(inputs.permute(0, 3, 1, 2))
        sizes = [tuple(x.shape[-2:])]
        for l in range(self.levels):
            x = avg_pool_nchw(x, self.factor)
            sizes.append(tuple(x.shape[-2:]))
            for r in range(self.repeats):
                x = getattr(self, f"enc_{l}_{r}")(x)
        for r in range(self.repeats):
            x = getattr(self, f"mid_{r}")(x)
        for i, l in enumerate(range(self.levels, 0, -1)):
            x = resize_bicubic_nchw(x, sizes[l - 1])
            for r in range(self.repeats):
                x = getattr(self, f"dec_{i}_{r}")(x)
        x = self.out_conv(x)
        if self.loss_type != "curl":
            return x.permute(0, 2, 3, 1)
        # curl head on the last channel (pycold-checkpoint.py:1099-1114):
        # the field is (H+2, W+2) and everything is cropped back
        a = x[:, -1] * self.a_bound
        u = dy_center(a)[..., :, 1:-1]
        v = -dx_center(a)[..., 1:-1, :]
        inner = x[:, :, 1:-1, 1:-1]
        if self.p_pred:
            parts = (inner[:, :-2], u[:, None], v[:, None], inner[:, -2:-1])
        else:
            parts = (inner[:, :-1], u[:, None], v[:, None])
        return torch.cat(parts, dim=1).permute(0, 2, 3, 1)
