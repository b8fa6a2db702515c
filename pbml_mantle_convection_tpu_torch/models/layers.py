"""Neural layers of the FluidNet family, as ``nn.Module``s (NCHW inside).

Counterpart of the JAX package's ``models/layers.py`` (reference:
pytorch_networks_convae.py:702-1065). Weights are OIHW. Parameter names
mirror the Flax tree, so a Flax parameter path maps onto a ``state_dict``
key by joining its parts with dots (``utils/flax_convert.py``).

Initialization reproduces torch's Conv2d defaults (U(-1/√fan_in,
1/√fan_in) for weight and bias), drawn from a seeded numpy generator so
a model is the same on every device.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

_ACTIVATIONS = {
    "selu": F.selu,
    "tanh": torch.tanh,
    "elu": F.elu,
    "silu": F.silu,
    "relu": F.relu,
    # torch nn.GELU() defaults to the exact (erf) form.
    "gelu": F.gelu,
}


def get_activation(name: str):
    try:
        return _ACTIVATIONS[name]
    except KeyError:
        raise ValueError(f"unknown activation {name!r}; "
                         f"options: {sorted(_ACTIVATIONS)}") from None


def _uniform(rng: np.random.Generator, shape, fan_in: int) -> nn.Parameter:
    bound = 1.0 / math.sqrt(fan_in)
    return nn.Parameter(torch.as_tensor(
        rng.uniform(-bound, bound, size=shape), dtype=torch.float32))


# torch padding_mode → F.pad mode
_PAD_MODES = {"zeros": "constant", "constant": "constant",
              "replicate": "replicate", "reflect": "reflect",
              "circular": "circular"}


class Conv2dTorch(nn.Module):
    """Plain conv with torch-default init and torch padding_mode
    semantics. ``padding``: "SAME" or "VALID"; ``explicit_padding``
    (ph, pw) overrides it."""

    def __init__(self, c_i: int, features: int, kernel_size: int,
                 rng: np.random.Generator, use_bias: bool = True,
                 padding: str = "SAME", pad_mode: str = "constant",
                 explicit_padding: Optional[Sequence[int]] = None):
        super().__init__()
        k = kernel_size
        self.weight = _uniform(rng, (features, c_i, k, k), k * k * c_i)
        self.bias = (_uniform(rng, (features,), k * k * c_i)
                     if use_bias else None)
        if explicit_padding is not None:
            ph, pw = explicit_padding
            self.pad = (pw, pw, ph, ph)
        elif padding == "SAME":
            lo = (k - 1) // 2
            self.pad = (lo, k - 1 - lo, lo, k - 1 - lo)
        else:
            self.pad = (0, 0, 0, 0)
        self.pad_mode = _PAD_MODES[pad_mode]

    def forward(self, x):
        if any(self.pad):
            x = F.pad(x, self.pad, mode=self.pad_mode)
        return F.conv2d(x, self.weight, self.bias)


# Weight classes of the learned-boundary conv, in the order the kernels
# index them: class = 3*row_class + col_class, where row class 0 holds
# output rows 0-1 (the "bottom" convs, which read the LAST input rows),
# 1 the interior rows and 2 rows H-2..H-1 (the "top" convs, which read
# the FIRST input rows); col class 0 holds cols 0-1, 2 cols W-2..W-1.
BLC_CLASSES = ("conv_bottom_left", "conv_bottom", "conv_bottom_right",
               "conv_left", "conv", "conv_right",
               "conv_top_left", "conv_top", "conv_top_right")


def blc_slab(k: int) -> int:
    """Edge slab width of the learned-boundary conv (bc = 1):
    k+1 for k == 5, else k (pytorch_networks_convae.py:1022-1030)."""
    return k + 1 if k == 5 else k


def blc_conv2d(x, w9: Sequence[torch.Tensor], bias):
    """Learned-boundary convolution: 9 VALID convs on edge slabs,
    stitched ``[bottom-slab, interior, top-slab]`` with the row flip of
    the reference (pytorch_networks_convae.py:1055-1060), plus bias.

    x: (B, C_in, H, W); w9: the 9 OIHW kernels in :data:`BLC_CLASSES`
    order; bias: (C_out,). Returns (B, C_out, H, W).
    """
    (w_bl, w_b, w_br, w_l, w_c, w_r, w_tl, w_t, w_tr) = w9
    p = blc_slab(w_c.shape[-1])
    top_left = F.conv2d(x[:, :, :p, :p], w_tl)
    bottom_left = F.conv2d(x[:, :, -p:, :p], w_bl)
    top_right = F.conv2d(x[:, :, :p, -p:], w_tr)
    bottom_right = F.conv2d(x[:, :, -p:, -p:], w_br)
    top = F.conv2d(x[:, :, :p, :], w_t)
    bottom = F.conv2d(x[:, :, -p:, :], w_b)
    left = F.conv2d(x[:, :, :, :p], w_l)
    right = F.conv2d(x[:, :, :, -p:], w_r)
    inner = F.conv2d(x, w_c)

    mid = torch.cat([left, inner, right], dim=3)
    top = torch.cat([top_left, top, top_right], dim=3)
    bottom = torch.cat([bottom_left, bottom, bottom_right], dim=3)
    y = torch.cat([bottom, mid, top], dim=2)
    return y + bias.view(1, -1, 1, 1)


class BoundaryLearnedConvolution2D(nn.Module):
    """"Learned padding": interior, 4 edge and 4 corner VALID convs
    stitched by :func:`blc_conv2d`, plus a zero-initialised learnable
    bias. Output size equals input size (bc_x = bc_y = 1)."""

    def __init__(self, c_i: int, features: int, kernel_size: int,
                 rng: np.random.Generator):
        super().__init__()
        for name in BLC_CLASSES:
            self.add_module(name, Conv2dTorch(
                c_i, features, kernel_size, rng, use_bias=False,
                padding="VALID"))
        self.learnable_bias = nn.Parameter(torch.zeros(features))

    def kernels(self):
        return [getattr(self, n).weight for n in BLC_CLASSES]

    def forward(self, x):
        return blc_conv2d(x, self.kernels(), self.learnable_bias)


class GroupNormTorch(nn.GroupNorm):
    """GroupNorm with torch defaults (eps=1e-5, affine)."""

    def __init__(self, num_groups: int, num_channels: int):
        super().__init__(num_groups, num_channels, eps=1e-5)


def fluid_layer_groups(c_o: int) -> int:
    """GroupNorm groups of a FluidLayer: c_o / min(4, c_o)
    (pytorch_networks_convae.py:788)."""
    return max(1, c_o // min(4, c_o))


class FluidLayer(nn.Module):
    """(Boundary-learned | padded) conv + GroupNorm + activation
    (reference: pytorch_networks_convae.py:702-799). ``r_p`` = "learned"
    selects :class:`BoundaryLearnedConvolution2D`; otherwise a SAME conv
    with that torch padding mode."""

    def __init__(self, c_i: int, features: int, rng: np.random.Generator,
                 act_fn: str = "selu", r_p: str = "zeros",
                 kernel_size: int = 3):
        super().__init__()
        if r_p == "learned":
            self.conv = BoundaryLearnedConvolution2D(
                c_i, features, kernel_size, rng)
        else:
            self.conv = Conv2dTorch(c_i, features, kernel_size, rng,
                                    padding="SAME", pad_mode=r_p)
        self.gn = GroupNormTorch(fluid_layer_groups(features), features)
        self.act = get_activation(act_fn)

    def forward(self, x):
        return self.act(self.gn(self.conv(x)))
