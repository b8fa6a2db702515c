"""Bicubic resampling as dense interpolation matrices, and VALID pooling.

Counterpart of the JAX package's ``ops/resize.py``. The matrices are the
separable cubic-convolution definition (Keys kernel, by default a =
-0.75 and half-pixel coordinates, clamped source indices) that torch's
bicubic ``align_corners=False`` also uses; ``a`` and ``align_corners``
are arguments, as in JAX's.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _cubic_kernel(x: np.ndarray, a: float = -0.75) -> np.ndarray:
    """Keys cubic convolution kernel with parameter ``a``."""
    x = np.abs(x)
    x2 = x * x
    x3 = x2 * x
    return np.where(
        x <= 1.0,
        (a + 2.0) * x3 - (a + 3.0) * x2 + 1.0,
        np.where(x < 2.0, a * x3 - 5.0 * a * x2 + 8.0 * a * x - 4.0 * a, 0.0),
    )


def _resize_matrix_np(in_size: int, out_size: int, a: float = -0.75,
                      align_corners: bool = False) -> np.ndarray:
    """(out_size, in_size) cubic interpolation matrix, float64: half-pixel
    source coordinates, or with ``align_corners`` the end pixels' centres
    on each other's. Every call of the same matrix, with its defaults
    given or not, reads one cache entry."""
    return _cubic_matrix_np(int(in_size), int(out_size), float(a),
                            bool(align_corners))


@functools.lru_cache(maxsize=None)
def _cubic_matrix_np(in_size: int, out_size: int, a: float,
                     align_corners: bool) -> np.ndarray:
    """:func:`_resize_matrix_np`, every argument given (its cache key)."""
    if in_size == out_size:
        return np.eye(in_size)
    M = np.zeros((out_size, in_size), dtype=np.float64)
    if align_corners and out_size > 1:
        src = np.arange(out_size) * ((in_size - 1) / (out_size - 1))
    else:
        src = (np.arange(out_size) + 0.5) * (in_size / out_size) - 0.5
    base = np.floor(src).astype(np.int64)
    frac = src - base
    for tap in range(-1, 3):
        w = _cubic_kernel(np.asarray(tap) - frac, a=a)
        idx = np.clip(base + tap, 0, in_size - 1)
        np.add.at(M, (np.arange(out_size), idx), w)
    return M


def resize_matrix(in_size: int, out_size: int, dtype, device,
                  a: float = -0.75, align_corners: bool = False):
    """:func:`_resize_matrix_np` as a tensor."""
    return torch.as_tensor(_resize_matrix_np(in_size, out_size, a,
                                             align_corners),
                           dtype=dtype, device=device)


def resize_bicubic_nchw(x, out_hw, a: float = -0.75,
                        align_corners: bool = False):
    """Bicubic resize of the last two axes of ``[..., H, W]``: first along
    H, then along W (the order of the JAX einsums)."""
    My = resize_matrix(x.shape[-2], out_hw[0], x.dtype, x.device, a,
                       align_corners)
    Mx = resize_matrix(x.shape[-1], out_hw[1], x.dtype, x.device, a,
                       align_corners)
    y = torch.einsum("oh,...hw->...ow", My, x)
    return torch.einsum("pw,...ow->...op", Mx, y)


# the JAX package's name for the resize of the last two axes
resize_bicubic = resize_bicubic_nchw


def resize_bicubic_nhwc(x, out_hw, a: float = -0.75,
                        align_corners: bool = False):
    """Bicubic resize of an NHWC tensor on its H and W axes."""
    y = resize_bicubic_nchw(x.permute(0, 3, 1, 2), out_hw, a, align_corners)
    return y.permute(0, 2, 3, 1)


def avg_pool_nchw(x, factor: int):
    """AvgPool2d(factor, stride=factor) with VALID padding: trailing
    rows/cols that do not fill a window are dropped (253 → 126)."""
    H, W = x.shape[-2], x.shape[-1]
    h, w = H // factor, W // factor
    x = x[..., : h * factor, : w * factor]
    x = x.reshape(x.shape[:-2] + (h, factor, w, factor))
    return x.mean(dim=(-3, -1))


def avg_pool_nhwc(x, factor: int):
    """:func:`avg_pool_nchw` on an NHWC tensor."""
    return avg_pool_nchw(x.permute(0, 3, 1, 2), factor).permute(0, 2, 3, 1)


@functools.lru_cache(maxsize=None)
def _lin_matrix_np(in_size: int, out_size: int,
                   align_corners: bool = False) -> np.ndarray:
    """(out_size, in_size) linear interpolation matrix, float64; half-pixel
    source coordinates clamped to the input, or ``align_corners``."""
    if in_size == out_size:
        return np.eye(in_size)
    M = np.zeros((out_size, in_size), dtype=np.float64)
    if align_corners and out_size > 1:
        src = np.arange(out_size) * (in_size - 1) / (out_size - 1)
    else:
        src = np.clip((np.arange(out_size) + 0.5) * in_size / out_size - 0.5,
                      0, in_size - 1)
    base = np.floor(src).astype(np.int64)
    frac = src - base
    hi = np.clip(base + 1, 0, in_size - 1)
    np.add.at(M, (np.arange(out_size), base), 1.0 - frac)
    np.add.at(M, (np.arange(out_size), hi), frac)
    return M


def resize_bilinear_nhwc(x, out_hw, align_corners: bool = False):
    """Bilinear resize of an NHWC tensor on its H and W axes (the
    reference's ``up_layer``, datasetio.py:94)."""
    def mat(n_in, n_out):
        return torch.as_tensor(_lin_matrix_np(n_in, n_out, align_corners),
                               dtype=x.dtype, device=x.device)

    y = torch.einsum("oh,bhwc->bowc", mat(x.shape[1], out_hw[0]), x)
    return torch.einsum("pw,bowc->bopc", mat(x.shape[2], out_hw[1]), y)
