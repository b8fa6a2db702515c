"""Neural layers of the FluidNet family, as ``nn.Module``s (NCHW inside).

Counterpart of the JAX package's ``models/layers.py`` (reference:
pytorch_networks_convae.py:702-1065). Weights are OIHW. Parameter names
mirror the Flax tree, so a Flax parameter path maps onto a ``state_dict``
key by joining its parts with dots (``utils/flax_convert.py``).

Initialization reproduces torch's Conv2d defaults (U(-1/√fan_in,
1/√fan_in) for weight and bias), drawn from a seeded numpy generator so
a model is the same on every device. Convolutions on the card run in full
float32 whatever PyTorch's TF32 flag says (:func:`float32_convs`).
"""

from __future__ import annotations

import contextlib
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


@contextlib.contextmanager
def float32_convs(x: torch.Tensor):
    """Inside the block, cuDNN convolutions of CUDA tensors run in full
    float32 even where ``torch.backends.cudnn.allow_tf32`` is True
    (PyTorch's default: TF32 keeps ~3 digits); the flag is restored.
    cuDNN reads the flag when a convolution runs, so a backward pass
    follows the flag of its own time: a train step runs inside one block
    (train/train_step.py)."""
    cudnn = torch.backends.cudnn
    if not (x.is_cuda and cudnn.allow_tf32):
        yield
        return
    cudnn.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32 = True


# torch padding_mode → F.pad mode
_PAD_MODES = {"zeros": "constant", "constant": "constant",
              "replicate": "replicate", "reflect": "reflect",
              "circular": "circular"}


class _WgradOffCudnnConv(torch.autograd.Function):
    """A VALID, stride-1 ``F.conv2d`` whose forward and input gradient run
    on cuDNN and whose weight (and bias) gradient runs with cuDNN off
    (PyTorch's own CUDA convolution: an im2col and a float32 GEMM). At
    the production grid cuDNN's float32 weight gradients of some convs
    (FFT and Winograd algorithms) are ~1e-4 to 1e-3 off where a direct
    sum is ~1e-6 (ROADMAP §3 faults 7 and 8,
    ``tools/torch_port_grad_precision.py``)."""

    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w)
        ctx.has_bias = b is not None
        return F.conv2d(x, w, b)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        gx = gw = gb = None
        if ctx.needs_input_grad[0]:
            gx = torch.nn.grad.conv2d_input(x.shape, w, gy)
        if ctx.needs_input_grad[1]:
            cudnn = torch.backends.cudnn
            enabled, cudnn.enabled = cudnn.enabled, False
            try:
                gw = torch.nn.grad.conv2d_weight(x, w.shape, gy)
            finally:
                cudnn.enabled = enabled
        if ctx.has_bias and ctx.needs_input_grad[2]:
            gb = gy.sum(dim=(0, 2, 3))
        return gx, gw, gb


def conv2d_routed(x, w, b=None, wgrad_off_cudnn: bool = False):
    """``F.conv2d(x, w, b)`` (VALID, stride 1); on the card under autograd
    with ``wgrad_off_cudnn``, its weight gradient runs with cuDNN off
    (:class:`_WgradOffCudnnConv`)."""
    if not (wgrad_off_cudnn and x.is_cuda and torch.is_grad_enabled()):
        return F.conv2d(x, w, b)
    return _WgradOffCudnnConv.apply(x, w, b)


class Conv2dTorch(nn.Module):
    """Plain conv with torch-default init and torch padding_mode
    semantics. ``padding``: "SAME" or "VALID"; ``explicit_padding``
    (ph, pw) overrides it. ``wgrad_off_cudnn`` takes the weight gradient
    on the card off cuDNN (:func:`conv2d_routed`)."""

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
        self.wgrad_off_cudnn = False

    def forward(self, x):
        if any(self.pad):
            x = F.pad(x, self.pad, mode=self.pad_mode)
        with float32_convs(x):
            return conv2d_routed(x, self.weight, self.bias,
                                 self.wgrad_off_cudnn)


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


def blc_conv2d(x, w9: Sequence[torch.Tensor], bias, bc_x: int = 1,
               bc_y: int = 1, band_conv=F.conv2d):
    """Learned-boundary convolution: 9 VALID convs on edge slabs,
    stitched ``[bottom-slab, interior, top-slab]`` with the row flip of
    the reference (pytorch_networks_convae.py:1055-1060), plus bias.

    x: (B, C_in, H, W); w9: the 9 OIHW kernels in :data:`BLC_CLASSES`
    order; bias: (C_out,). Returns (B, C_out, H + 2(bc_y - 1),
    W + 2(bc_x - 1)): the slabs are ``bc - 1`` wider than
    :func:`blc_slab`. ``band_conv(x, w)`` is the VALID conv of the 8
    edge and corner slabs.
    """
    (w_bl, w_b, w_br, w_l, w_c, w_r, w_tl, w_t, w_tr) = w9
    px = blc_slab(w_c.shape[-1]) + bc_x - 1
    py = blc_slab(w_c.shape[-1]) + bc_y - 1

    with float32_convs(x):
        top_left = band_conv(x[:, :, :py, :px], w_tl)
        bottom_left = band_conv(x[:, :, -py:, :px], w_bl)
        top_right = band_conv(x[:, :, :py, -px:], w_tr)
        bottom_right = band_conv(x[:, :, -py:, -px:], w_br)
        top = band_conv(x[:, :, :py, :], w_t)
        bottom = band_conv(x[:, :, -py:, :], w_b)
        left = band_conv(x[:, :, :, :px], w_l)
        right = band_conv(x[:, :, :, -px:], w_r)
        inner = F.conv2d(x, w_c)

    mid = torch.cat([left, inner, right], dim=3)
    top = torch.cat([top_left, top, top_right], dim=3)
    bottom = torch.cat([bottom_left, bottom, bottom_right], dim=3)
    y = torch.cat([bottom, mid, top], dim=2)
    return y + bias.view(1, -1, 1, 1)


class BoundaryLearnedConvolution2D(nn.Module):
    """"Learned padding": interior, 4 edge and 4 corner VALID convs
    stitched by :func:`blc_conv2d`, plus a zero-initialised learnable
    bias. Output size (H + 2(bc_y - 1), W + 2(bc_x - 1)): the input's
    with bc_x = bc_y = 1. ``wgrad_off_cudnn`` takes the 8 slab convs'
    weight gradients on the card off cuDNN (:func:`conv2d_routed`); the
    interior conv's stay on cuDNN."""

    def __init__(self, c_i: int, features: int, kernel_size: int,
                 rng: np.random.Generator, bc_x: int = 1, bc_y: int = 1):
        super().__init__()
        for name in BLC_CLASSES:
            self.add_module(name, Conv2dTorch(
                c_i, features, kernel_size, rng, use_bias=False,
                padding="VALID"))
        self.learnable_bias = nn.Parameter(torch.zeros(features))
        self.bc_x, self.bc_y = bc_x, bc_y
        self.wgrad_off_cudnn = False

    def kernels(self):
        return [getattr(self, n).weight for n in BLC_CLASSES]

    def forward(self, x):
        return blc_conv2d(x, self.kernels(), self.learnable_bias,
                          self.bc_x, self.bc_y, self._band_conv)

    def _band_conv(self, xs, w):
        return conv2d_routed(xs, w, None, self.wgrad_off_cudnn)


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
    selects :class:`BoundaryLearnedConvolution2D` (with ``bc_x``,
    ``bc_y``); otherwise a SAME conv with that torch padding mode."""

    def __init__(self, c_i: int, features: int, rng: np.random.Generator,
                 act_fn: str = "selu", r_p: str = "zeros",
                 kernel_size: int = 3, bc_x: int = 1, bc_y: int = 1):
        super().__init__()
        if r_p == "learned":
            self.conv = BoundaryLearnedConvolution2D(
                c_i, features, kernel_size, rng, bc_x, bc_y)
        else:
            self.conv = Conv2dTorch(c_i, features, kernel_size, rng,
                                    padding="SAME", pad_mode=r_p)
        self.gn = GroupNormTorch(fluid_layer_groups(features), features)
        self.act = get_activation(act_fn)

    def forward(self, x):
        return self.act(self.gn(self.conv(x)))
