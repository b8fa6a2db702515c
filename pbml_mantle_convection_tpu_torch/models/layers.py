"""Neural layers of the FluidNet family, as ``nn.Module``s (NCHW inside).

Counterpart of the JAX package's ``models/layers.py`` (reference:
symmetric_layers_torch.py, pytorch_networks_convae.py:571-1065): plain,
symmetric, boundary-learned and spectral convs, ``FluidLayer`` and
``SpectralFluidLayer``. Weights are OIHW. Parameter names mirror the Flax
tree, so a Flax parameter path maps onto a ``state_dict`` key by joining
its parts with dots (``utils/flax_convert.py``).

Initialization reproduces torch's Conv2d defaults (U(-1/√fan_in,
1/√fan_in) for weight and bias), drawn from a seeded numpy generator so
a model is the same on every device. Convolutions on the card run in full
float32 whatever PyTorch's TF32 flag says (:func:`float32_convs`).
Dropout draws its mask from an explicit ``torch.Generator``
(:func:`dropout`); without one a layer is deterministic, as a Flax layer
with ``deterministic=True``.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

def sine30(x):
    """SIREN-style activation sin(30 x) (reference ``Sine(30.)``)."""
    return torch.sin(30.0 * x)


_ACTIVATIONS = {
    "selu": F.selu,
    "sine": sine30,
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
    def forward(ctx, x, w, b, dilation=1):
        ctx.save_for_backward(x, w)
        ctx.has_bias, ctx.dilation = b is not None, dilation
        return F.conv2d(x, w, b, dilation=dilation)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        d = ctx.dilation
        gx = gw = gb = None
        if ctx.needs_input_grad[0]:
            gx = torch.nn.grad.conv2d_input(x.shape, w, gy, dilation=d)
        if ctx.needs_input_grad[1]:
            cudnn = torch.backends.cudnn
            enabled, cudnn.enabled = cudnn.enabled, False
            try:
                gw = torch.nn.grad.conv2d_weight(x, w.shape, gy, dilation=d)
            finally:
                cudnn.enabled = enabled
        if ctx.has_bias and ctx.needs_input_grad[2]:
            gb = gy.sum(dim=(0, 2, 3))
        return gx, gw, gb, None


def conv2d_routed(x, w, b=None, wgrad_off_cudnn: bool = False,
                  dilation: int = 1):
    """``F.conv2d(x, w, b, dilation=dilation)`` (VALID, stride 1); on the
    card under autograd with ``wgrad_off_cudnn``, its weight gradient runs
    with cuDNN off (:class:`_WgradOffCudnnConv`)."""
    if not (wgrad_off_cudnn and x.is_cuda and torch.is_grad_enabled()):
        return F.conv2d(x, w, b, dilation=dilation)
    return _WgradOffCudnnConv.apply(x, w, b, dilation)


def same_pad(k: int, dilation: int = 1) -> tuple:
    """F.pad's (left, right, top, bottom) of a SAME conv: dilation·(k−1)
    in all, its half (rounded down) before and the rest after."""
    total = dilation * (k - 1)
    lo = total // 2
    return (lo, total - lo, lo, total - lo)


class Conv2dTorch(nn.Module):
    """Plain conv with torch-default init and torch padding_mode
    semantics. ``padding``: "SAME" (:func:`same_pad` of the dilated
    kernel) or "VALID"; ``explicit_padding`` (ph, pw) overrides it.
    ``wgrad_off_cudnn`` takes the weight gradient on the card off cuDNN
    (:func:`conv2d_routed`)."""

    def __init__(self, c_i: int, features: int, kernel_size: int,
                 rng: np.random.Generator, use_bias: bool = True,
                 padding: str = "SAME", pad_mode: str = "constant",
                 explicit_padding: Optional[Sequence[int]] = None,
                 dilation: int = 1):
        super().__init__()
        k = kernel_size
        self.weight = _uniform(rng, (features, c_i, k, k), k * k * c_i)
        self.bias = (_uniform(rng, (features,), k * k * c_i)
                     if use_bias else None)
        _init_padding(self, k, padding, pad_mode, explicit_padding, dilation)

    def kernel(self) -> torch.Tensor:
        """The OIHW kernel the conv applies."""
        return self.weight

    def forward(self, x):
        return _padded_conv(self, x)


def _init_padding(conv, k, padding, pad_mode, explicit_padding=None,
                  dilation=1):
    if explicit_padding is not None:
        ph, pw = explicit_padding
        conv.pad = (pw, pw, ph, ph)
    elif padding == "SAME":
        conv.pad = same_pad(k, dilation)
    else:
        conv.pad = (0, 0, 0, 0)
    conv.pad_mode = _PAD_MODES[pad_mode]
    conv.dilation = dilation
    conv.wgrad_off_cudnn = False


def _padded_conv(conv, x):
    """A conv module's forward: its padding, then :func:`conv2d_routed`
    of its kernel under the float32 guard."""
    if any(conv.pad):
        x = F.pad(x, conv.pad, mode=conv.pad_mode)
    with float32_convs(x):
        return conv2d_routed(x, conv.kernel(), conv.bias,
                             conv.wgrad_off_cudnn, conv.dilation)


def default_symmetry(c_o: int) -> dict:
    """The reference's symmetry split: h = c_o/4 (c_o/2 when c_o ≤ 4),
    v = 0, hv = 0 (pytorch_networks_convae.py:755-757, 852-854)."""
    h = c_o // 4 if c_o > 4 else c_o // 2
    return {"h": h, "v": 0, "hv": 0}


def _symmetry(symmetry, keys) -> dict:
    s = {k: 0 for k in keys}
    s.update(symmetry or {})
    return s


class SymmetricConv2d(nn.Module):
    """Conv2d with weight sharing between reflection-symmetric filters
    (reference: symmetric_layers_torch.py:21-138). ``weight`` holds the
    unique filters only, (n_unique, c_i, k, k); :meth:`kernel` appends
    the mirrored ones at call time, in the reference's (and JAX's) part
    order: all unique filters, then ``h``/2 of them flipped along kernel
    W, ``v``/2 flipped along kernel H, and for ``hv`` three parts (W, H,
    both) of ``hv``/4 filters each. ``padding`` "SAME" pads
    :func:`same_pad` of the dilated kernel with ``pad_mode``."""

    def __init__(self, c_i: int, features: int, kernel_size: int,
                 rng: np.random.Generator, symmetry: Optional[dict] = None,
                 use_bias: bool = True, padding: str = "VALID",
                 pad_mode: str = "constant", dilation: int = 1):
        super().__init__()
        k = kernel_size
        self.symmetry = _symmetry(symmetry, ("h", "v", "hv"))
        n_unique = self.unique_out_channels(features, self.symmetry)
        self.weight = _uniform(rng, (n_unique, c_i, k, k), k * k * c_i)
        self.bias = (_uniform(rng, (features,), k * k * c_i)
                     if use_bias else None)
        _init_padding(self, k, padding, pad_mode, dilation=dilation)

    @staticmethod
    def unique_out_channels(features: int, symmetry: dict) -> int:
        s = _symmetry(symmetry, ("h", "v", "hv"))
        if s["h"] % 2 or s["v"] % 2:
            raise ValueError("h/v symmetric filter counts must be even")
        if s["hv"] % 4:
            raise ValueError("hv symmetric filter count must be divisible "
                             "by 4")
        if s["h"] + s["v"] + s["hv"] > features:
            raise ValueError("symmetric channels exceed out channels")
        return features - s["h"] // 2 - s["v"] // 2 - 3 * s["hv"] // 4

    def kernel(self) -> torch.Tensor:
        """The full (features, c_i, k, k) kernel."""
        w, s = self.weight, self.symmetry
        parts, ix = [w], 0
        for key, dims in (("h", (3,)), ("v", (2,))):
            if s[key] > 0:
                n = s[key] // 2
                parts.append(torch.flip(w[ix:ix + n], dims))
                ix += n
        if s["hv"] > 0:
            n = s["hv"] // 4
            blk = w[ix:ix + n]
            parts += [torch.flip(blk, (3,)), torch.flip(blk, (2,)),
                      torch.flip(blk, (2, 3))]
        return torch.cat(parts, dim=0)

    def forward(self, x):
        return _padded_conv(self, x)


class SymmetricConv3d(nn.Module):
    """3-D symmetric convolution, NCDHW data (reference:
    symmetric_layers_torch.py:141-309). Symmetry keys: 'h', 'v', 'z'
    (pairs, flipping kernel W, H, D), 'hv', 'hz', 'vz' (three parts each:
    the first axis, the second, both) and 'hvz' (seven parts), in JAX's
    order. ``weight``: (n_unique, c_i, k, k, k). ``padding`` "SAME" pads
    zeros, (k−1)//2 before and the rest after on each axis."""

    _KEYS = ("h", "v", "z", "hv", "hz", "vz", "hvz")

    def __init__(self, c_i: int, features: int, kernel_size: int,
                 rng: np.random.Generator, symmetry: Optional[dict] = None,
                 use_bias: bool = True, padding: str = "SAME"):
        super().__init__()
        k = kernel_size
        self.symmetry = _symmetry(symmetry, self._KEYS)
        n_unique = self.unique_out_channels(features, self.symmetry)
        self.weight = _uniform(rng, (n_unique, c_i, k, k, k), k ** 3 * c_i)
        self.bias = (_uniform(rng, (features,), k ** 3 * c_i)
                     if use_bias else None)
        lo = (k - 1) // 2
        self.pad = (lo, k - 1 - lo) * 3 if padding == "SAME" else (0,) * 6

    @classmethod
    def unique_out_channels(cls, features: int, symmetry: dict) -> int:
        s = _symmetry(symmetry, cls._KEYS)
        for key, val in s.items():
            if key in ("h", "v", "z") and val % 2:
                raise ValueError("pair symmetries must be even")
            if key in ("hv", "hz", "vz") and val % 4:
                raise ValueError("quad symmetries must be divisible by 4")
            if key == "hvz" and val % 8:
                raise ValueError("hvz must be divisible by 8")
        if sum(s.values()) > features:
            raise ValueError("symmetric channels exceed out channels")
        return (features - s["h"] // 2 - s["v"] // 2 - s["z"] // 2
                - 3 * s["hv"] // 4 - 3 * s["hz"] // 4 - 3 * s["vz"] // 4
                - 7 * s["hvz"] // 8)

    def kernel(self) -> torch.Tensor:
        """The full (features, c_i, k, k, k) kernel; h → dim 4 (kernel
        W), v → dim 3 (H), z → dim 2 (D)."""
        w, s = self.weight, self.symmetry
        parts, ix = [w], 0
        for key, dims in (("h", (4,)), ("v", (3,)), ("z", (2,))):
            if s[key] > 0:
                n = s[key] // 2
                parts.append(torch.flip(w[ix:ix + n], dims))
                ix += n
        for key, (a, b) in (("hv", (4, 3)), ("hz", (4, 2)), ("vz", (3, 2))):
            if s[key] > 0:
                n = s[key] // 4
                blk = w[ix:ix + n]
                parts += [torch.flip(blk, (a,)), torch.flip(blk, (b,)),
                          torch.flip(blk, (a, b))]
                ix += n
        if s["hvz"] > 0:
            n = s["hvz"] // 8
            blk = w[ix:ix + n]
            parts += [torch.flip(blk, d) for d in
                      ((4,), (3,), (2,), (2, 3), (2, 4), (3, 4), (2, 3, 4))]
        return torch.cat(parts, dim=0)

    def forward(self, x):
        if any(self.pad):
            x = F.pad(x, self.pad)
        with float32_convs(x):
            return F.conv3d(x, self.kernel(), self.bias)


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
               bc_y: int = 1, band_conv=F.conv2d, inner_conv=F.conv2d):
    """Learned-boundary convolution: 9 VALID convs on edge slabs,
    stitched ``[bottom-slab, interior, top-slab]`` with the row flip of
    the reference (pytorch_networks_convae.py:1055-1060), plus bias.

    x: (B, C_in, H, W); w9: the 9 OIHW kernels in :data:`BLC_CLASSES`
    order; bias: (C_out,). Returns (B, C_out, H + 2(bc_y - 1),
    W + 2(bc_x - 1)): the slabs are ``bc - 1`` wider than
    :func:`blc_slab`. ``band_conv(x, w)`` is the VALID conv of the 8
    edge and corner slabs, ``inner_conv(x, w)`` the interior's.
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
        inner = inner_conv(x, w_c)

    mid = torch.cat([left, inner, right], dim=3)
    top = torch.cat([top_left, top, top_right], dim=3)
    bottom = torch.cat([bottom_left, bottom, bottom_right], dim=3)
    y = torch.cat([bottom, mid, top], dim=2)
    return y + bias.view(1, -1, 1, 1)


class BoundaryLearnedConvolution2D(nn.Module):
    """"Learned padding": interior, 4 edge and 4 corner VALID convs
    stitched by :func:`blc_conv2d`, plus a zero-initialised learnable
    bias; with ``use_symm`` each of the 9 is a :class:`SymmetricConv2d`
    without bias. Output size (H + 2(bc_y - 1), W + 2(bc_x - 1)): the
    input's with bc_x = bc_y = 1. ``wgrad_off_cudnn`` takes the 8 slab convs'
    weight gradients on the card off cuDNN (:func:`conv2d_routed`)."""

    def __init__(self, c_i: int, features: int, kernel_size: int,
                 rng: np.random.Generator, bc_x: int = 1, bc_y: int = 1,
                 use_symm: bool = False):
        super().__init__()
        for name in BLC_CLASSES:
            if use_symm:
                conv = SymmetricConv2d(c_i, features, kernel_size, rng,
                                       symmetry=default_symmetry(features),
                                       use_bias=False)
            else:
                conv = Conv2dTorch(c_i, features, kernel_size, rng,
                                   use_bias=False, padding="VALID")
            self.add_module(name, conv)
        self.learnable_bias = nn.Parameter(torch.zeros(features))
        self.bc_x, self.bc_y = bc_x, bc_y
        self.wgrad_off_cudnn = False

    def kernels(self):
        """The 9 full OIHW kernels in :data:`BLC_CLASSES` order (a
        symmetric conv's with its mirrored filters)."""
        return [getattr(self, n).kernel() for n in BLC_CLASSES]

    def forward(self, x):
        return blc_conv2d(x, self.kernels(), self.learnable_bias,
                          self.bc_x, self.bc_y, self._band_conv)

    def _band_conv(self, xs, w):
        return conv2d_routed(xs, w, None, self.wgrad_off_cudnn)


class GroupNormTorch(nn.GroupNorm):
    """GroupNorm with torch defaults (eps=1e-5, affine)."""

    def __init__(self, num_groups: int, num_channels: int):
        super().__init__(num_groups, num_channels, eps=1e-5)


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` computed in its parameters' type and returned in
    the input's: Flax's ``nn.LayerNorm`` with a ``dtype`` (statistics and
    the affine map in float32, the result cast to the input's type)."""

    def forward(self, x):
        return super().forward(x.to(self.weight.dtype)).to(x.dtype)


def keep_float32(module: nn.Module, types, dtype) -> None:
    """Flax's built-in layers (``nn.Dense``, ``nn.LayerNorm``) keep
    float32 parameters (their ``param_dtype``) under a 16-bit ``dtype``
    and cast them to it at use, where the package's own layers store them
    in the model's dtype: with a 16-bit ``dtype`` the parameters of the
    submodules of ``types`` go back to float32."""
    if dtype in (torch.bfloat16, torch.float16):
        for m in module.modules():
            if isinstance(m, types):
                m.float()


def fluid_layer_groups(c_o: int) -> int:
    """GroupNorm groups of a FluidLayer: c_o / min(4, c_o)
    (pytorch_networks_convae.py:788)."""
    return max(1, c_o // min(4, c_o))


def dropout(x, rate: float, generator: torch.Generator):
    """Inverted dropout as Flax's ``nn.Dropout``: each element kept with
    probability 1 − ``rate`` (a Bernoulli mask drawn from ``generator``,
    on x's device) and scaled by 1/(1 − rate), the others 0."""
    keep = torch.empty_like(x).bernoulli_(1.0 - rate, generator=generator)
    return torch.where(keep.bool(), x / (1.0 - rate), torch.zeros_like(x))


class FluidLayer(nn.Module):
    """(Boundary-learned | symmetric | plain) conv + GroupNorm +
    activation + dropout (reference: pytorch_networks_convae.py:702-799).
    ``r_p`` = "learned" selects :class:`BoundaryLearnedConvolution2D`
    (with ``bc_x``, ``bc_y``, ``use_symm``; ``dilation`` unused);
    otherwise a SAME conv with that torch padding mode and ``dilation``,
    a :class:`SymmetricConv2d` with ``use_symm``. With ``drop_rate`` > 0,
    ``forward(x, generator)`` drops after the activation when it is given
    a generator (training), and not without one."""

    def __init__(self, c_i: int, features: int, rng: np.random.Generator,
                 act_fn: str = "selu", r_p: str = "zeros",
                 kernel_size: int = 3, bc_x: int = 1, bc_y: int = 1,
                 use_symm: bool = False, dilation: int = 1,
                 drop_rate: float = 0.0):
        super().__init__()
        if r_p == "learned":
            self.conv = BoundaryLearnedConvolution2D(
                c_i, features, kernel_size, rng, bc_x, bc_y, use_symm)
        elif use_symm:
            self.conv = SymmetricConv2d(
                c_i, features, kernel_size, rng,
                symmetry=default_symmetry(features), padding="SAME",
                pad_mode=r_p, dilation=dilation)
        else:
            self.conv = Conv2dTorch(c_i, features, kernel_size, rng,
                                    padding="SAME", pad_mode=r_p,
                                    dilation=dilation)
        self.gn = GroupNormTorch(fluid_layer_groups(features), features)
        self.act = get_activation(act_fn)
        self.drop_rate = drop_rate

    def forward(self, x, generator: Optional[torch.Generator] = None):
        y = self.act(self.gn(self.conv(x)))
        if self.drop_rate > 0.0 and generator is not None:
            y = dropout(y, self.drop_rate, generator)
        return y


class SpectralConv2d(nn.Module):
    """2-D Fourier (FNO) layer: rFFT2 → the lowest ``modes1`` × ``modes2``
    modes mixed by complex weights → irFFT2 (reference:
    pytorch_networks_convae.py:571-635). The real and imaginary weights
    are separate parameters, (c_i, features, modes1, modes2) each, drawn
    as (1/(c_i·features))·U(0, 1). The top rows' modes are written before
    the bottom rows', so where the two overlap (H < 2·modes1) the bottom
    ones win, as in JAX."""

    def __init__(self, c_i: int, features: int, rng: np.random.Generator,
                 modes1: int = 4, modes2: int = 4):
        super().__init__()
        self.features, self.modes1, self.modes2 = features, modes1, modes2
        scale = 1.0 / (c_i * features)
        shape = (c_i, features, modes1, modes2)
        for name in ("weights1_real", "weights1_imag", "weights2_real",
                     "weights2_imag"):
            setattr(self, name, nn.Parameter(torch.as_tensor(
                scale * rng.uniform(0.0, 1.0, size=shape),
                dtype=torch.float32)))

    def forward(self, x):
        B, _, H, W = x.shape
        m1, m2 = self.modes1, self.modes2
        w1 = torch.complex(self.weights1_real, self.weights1_imag)
        w2 = torch.complex(self.weights2_real, self.weights2_imag)
        x_ft = torch.fft.rfft2(x)
        out_ft = torch.zeros((B, self.features, H, W // 2 + 1),
                             dtype=x_ft.dtype, device=x.device)
        out_ft[:, :, :m1, :m2] = torch.einsum(
            "bixy,ioxy->boxy", x_ft[:, :, :m1, :m2], w1)
        out_ft[:, :, -m1:, :m2] = torch.einsum(
            "bixy,ioxy->boxy", x_ft[:, :, -m1:, :m2], w2)
        return torch.fft.irfft2(out_ft, s=(H, W)).to(x.dtype)


class SpectralFluidLayer(nn.Module):
    """SpectralConv2d + GroupNorm (max(1, features/4) groups) +
    activation (reference: pytorch_networks_convae.py:638-699); no
    dropout (``generator`` is accepted and unused, as JAX's
    ``deterministic``)."""

    def __init__(self, c_i: int, features: int, rng: np.random.Generator,
                 act_fn: str = "selu"):
        super().__init__()
        self.conv = SpectralConv2d(c_i, features, rng)
        self.gn = GroupNormTorch(max(1, features // 4), features)
        self.act = get_activation(act_fn)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        return self.act(self.gn(self.conv(x)))


def fluid_layer(c_i: int, features: int, rng: np.random.Generator,
                act_fn: str, r_p: str, kernel_size: int,
                use_symm: bool = False, dilation: int = 1,
                drop_rate: float = 0.0, spectral: bool = False,
                bc_x: int = 1, bc_y: int = 1) -> nn.Module:
    """A :class:`SpectralFluidLayer` with ``spectral``, else a
    :class:`FluidLayer` with the options (JAX ``fluidnet.py::
    _fluid_layer`` and ``Unet._layer``)."""
    if spectral:
        return SpectralFluidLayer(c_i, features, rng, act_fn)
    return FluidLayer(c_i, features, rng, act_fn, r_p, kernel_size,
                      bc_x=bc_x, bc_y=bc_y, use_symm=use_symm,
                      dilation=dilation, drop_rate=drop_rate)
